"""The whole main-stage step's share of the TF32 peak with HuMoR's term:
FLOPs a step (counts/fit_step_humor.py at the cell's shapes) x the
unprofiled rate."""
from portbench.harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, "fit_step_humor")
