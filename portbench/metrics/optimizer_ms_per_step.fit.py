"""Device ms a main-stage step of the optimizer's foreach kernels
(multi_tensor_apply: GroupAdam in fit/optimizer.py)."""
from portbench.harness.readers import FOREACH, ms_per_step


def read(rec):
    return ms_per_step(rec, FOREACH)
