"""run.py on a machine without a card: it fails with its reason and
prints no result; it does not fall back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from portbench.harness.cell import REPO


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cv_47x600",
         "--seed", str(2 ** 33 + 5), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "BENCH_RUN": "1"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_unknown_cell_fails():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "no_such_cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
