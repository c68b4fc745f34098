"""Build and load the port's CUDA kernels from ``nemo_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/nemo_tpu_torch/`` at the repository root, named by a
hash of the sources, so an edit to any source rebuilds it and an unchanged
tree reuses it. Nothing is compiled or loaded at import time: the first
kernel launch calls :func:`library`.

A missing ``nvcc``, a failed build or a machine without a card raises with
the reason (the compiler's output included); there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "nemo_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu; every function returns a cudaError_t as int.
_SIGNATURES = {
    # R_l, t_l, parents (host int*), order (host int*), B, J, R_g, t_g, stream
    "nemo_fk_fwd": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    # R_l, t_l, R_g, gR_g, gt_g, parents, order, B, J, acc, gR_l, gt_l, stream
    "nemo_fk_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # B, V, pf_o, A_o, pf_r, A_r, vsh_t, posedirs_t, W_t, grad,
    # partial, sign, vp, gvp, total, gpf, gA, gvsh, stream
    "nemo_v2v_l1": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # number of per-block partial sums nemo_v2v_l1 writes for (B, V)
    "nemo_v2v_num_partials": [_I, _I],
}

build_seconds = None  # wall time of the build this process ran, if any


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of nemo_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    """Where the library for the current sources lives (or will)."""
    h = hashlib.sha256()
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libnemo_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if their library is not built yet; returns its
    path. The build writes to a temporary name and renames it into place,
    so a concurrent or interrupted build never leaves a half-written
    library under the final name."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "nemo_tpu_torch CUDA kernels need a CUDA device, and "
            "torch.cuda.is_available() is False")
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C side's pointer."""
    return torch.cuda.current_stream(device).cuda_stream


def route(*tensors: torch.Tensor) -> str:
    """"cpu" when every tensor lies on the CPU (the caller takes the plain
    PyTorch version), "cuda" when every tensor lies on a CUDA device (the
    caller launches its kernel). Anything else raises: a wrapper never
    routes device tensors to the plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return "cuda"
    raise ValueError(f"kernel inputs lie on {sorted(kinds)}: expected all on "
                     "the CPU (plain version) or all on one CUDA device")


def check_input(name: str, t: torch.Tensor, shape, device) -> None:
    """Validate one kernel operand: float32, contiguous, on ``device``,
    with ``shape`` (None entries match any size)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
