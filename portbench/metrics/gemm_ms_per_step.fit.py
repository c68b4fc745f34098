"""Device ms a main-stage step of cuBLAS's GEMM and GEMV kernels (the
MotionNet, VPoser and the joint tables: modules/networks.py and the
priors)."""
from portbench.harness.readers import CUBLAS, ms_per_step


def read(rec):
    return ms_per_step(rec, CUBLAS)
