"""The control on the card: the reference one precision lower (TF32) in
the program's place fails the cell's numbers, where the program passes,
at a size a test run holds; so does the half-batch fault. The
benchmark's own runs do not run it; portbench/controls.py reads the same
at the cells' own sizes."""

import pytest
import torch

from portbench.tests.test_portbench_reference import CELLS, files_spec

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mod, config, traffic, limits = files_spec(cell)
    drv = mod.Driver(config, traffic, 2 ** 31 + 3, torch.device("cuda"),
                     limits)
    got = drv.readings()
    assert all(v <= lim for _, v, lim in got["program"])
    assert any(v > lim for _, v, lim in got["control_tf32"])
    assert any(v > lim for _, v, lim in got["fault_half_batch"])
