"""The device's idle share in the fit: 100 (1 - busy ms a step x the
unprofiled steps a second / 1000), busy ms the union of the device
operations' intervals over the traced steps."""
from portbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
