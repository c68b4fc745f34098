"""Build and load the port's CUDA kernels from ``nemo_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
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
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every function returns a cudaError_t as int.
_SIGNATURES = {
    # R_l, t_l, tree (host int*, ops/fk.py kinematic_tree().packed), B, J,
    # R_g, t_g, stream
    "nemo_fk_fwd": [_P, _P, _P, _I, _I, _P, _P, _P],
    # R_l, t_l, R_g, gR_g, gt_g, tree, B, J, gR_l, gt_l, stream
    "nemo_fk_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # B, J, backward, stream: an empty kernel on K1's grid (launch floor)
    "nemo_fk_empty": [_I, _I, _I, _P],
    # backward, J, out int[4]: the K1 kernel's registers a thread, static
    # and dynamic (at J joints) shared memory bytes, local (spill) bytes
    "nemo_fk_attributes": [_I, _I, _P],
    # B, V, pf_o, A_o, pf_r, A_r, vsh_t, posedirs_t, W_t, posedirs_pad,
    # its row pitch, mode, scratch, sign, vp, total, gpf, gA, gvsh, stream
    # (the _bf16 twins of this and the skinning entries below take bf16
    # tables and vp; nemo_v2v_l1_bf16 no padded table or pitch)
    "nemo_v2v_l1": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P],
    "nemo_v2v_l1_bf16": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P],
    # floats of scratch nemo_v2v_l1 (_bf16: nemo_v2v_l1_bf16) needs at (B,
    # V, mode), -1 if refused
    "nemo_v2v_scratch_floats": [_I, _I, _I],
    "nemo_v2v_scratch_floats_bf16": [_I, _I, _I],
    # out int[4]: the fused K2 kernel's registers a thread, static and
    # dynamic shared memory bytes, local (spill) bytes
    "nemo_v2v_fused_attributes": [_P],
    "nemo_v2v_fused_attributes_bf16": [_P],
    # mesh_bf16 (the mesh's type: 0 f32, 1 bf16), B, V, pf, A, vsh_t,
    # posedirs_t, W_t, verts, stream
    "nemo_skin_fwd": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "nemo_skin_fwd_bf16": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # sides (1 K3f, 2 K2's pair mode), mesh_bf16, out int[4]: the forward
    # kernel's registers a thread, static and dynamic shared memory bytes,
    # local (spill) bytes
    "nemo_skin_fwd_attributes": [_I, _I, _P],
    "nemo_skin_fwd_attributes_bf16": [_I, _I, _P],
    # mesh_bf16, B, V, pf, A, vsh_t, posedirs_t, W_t, g, vp_in, scratch,
    # gpf, gA, gvsh, stream
    "nemo_skin_bwd": [_I, _I, _I] + [_P] * 12,
    "nemo_skin_bwd_bf16": [_I, _I, _I] + [_P] * 12,
    # floats of scratch nemo_skin_bwd needs at (B, V), -1 if refused
    "nemo_skin_bwd_scratch_floats": [_I, _I],
    # mode (1 recompute vp, 2 stored vp), mesh_bf16, out int[4]: the
    # one-pass K3b kernel's registers a thread, static and dynamic shared
    # memory bytes, local (spill) bytes
    "nemo_skin_bwd_attributes": [_I, _I, _P],
    "nemo_skin_bwd_attributes_bf16": [_I, _I, _P],
    # N, T, H, W, th, tw, ntx, attr, codes, starts, counts, ints, keys, z,
    # fid, bary, stream
    "nemo_raster_stream": [_I] * 7 + [_P] * 10,
    # N, T, H, W, th, tw, ntx, F, K, attr_face, tbl, counts, ints, keys, z,
    # fid, bary, stream
    "nemo_raster_gather": [_I] * 9 + [_P] * 9,
    # which (0/1 the stream/gather fold, 2/3 their finalise, 4 the list
    # kernel), out int[4]: registers a thread, static and dynamic shared
    # memory bytes, local (spill) bytes
    "nemo_raster_attributes": [_I, _P],
    # a, b, T, N, M, q, ranges, range (ops/chamfer.py nn_split), dist,
    # idx, stream
    "nemo_chamfer_nn": [_P, _P] + [_I] * 6 + [_P, _P, _P],
    # T, N, M, q, ranges, stream: an empty kernel on K4's grid (launch
    # floor)
    "nemo_chamfer_empty": [_I] * 5 + [_P],
    # q, out int[4]: K4's registers a thread, static and dynamic (at 16
    # ranges) shared memory bytes, local (spill) bytes
    "nemo_chamfer_attributes": [_I, _P],
    # floats of scratch nemo_mlp_fwd/_bwd need at (B, D, H, O), -1 if refused
    "nemo_mlp_scratch_floats": [_I, _I, _I, _I],
    # arith (0 3xTF32, 1 bf16x3, 2 bf16: ops/mlp.py _ARITH), B, D, H, O, x,
    # W1, b1, W2, b2, W3, b3, Wo, bo, out, h1, h2, z, scratch, stream
    "nemo_mlp_fwd": [_I] * 5 + [_P] * 15,
    # arith, B, D, H, O, gout, x, h1, h2, z, W1, W2, W3, Wo, gx, gW1, gb1,
    # gW2, gb2, gW3, gb3, gWo, gbo, scratch, stream
    "nemo_mlp_bwd": [_I] * 5 + [_P] * 20,
    # pair (0 the forward's instantiation, 1 the backward's), arith, out
    # int[4]: the K6 GEMM kernel's registers a thread, static and dynamic
    # shared memory bytes, local (spill) bytes
    "nemo_mlp_attributes": [_I, _I, _P],
    # R, C, G, x, gamma, beta, eps, y, mean, rstd, stream
    "nemo_gn_relu_fwd": [_I, _I, _I, _P, _P, _P, _F, _P, _P, _P, _P],
    # R, C, G, x, gamma, beta, mean, rstd, gy, dx, dgamma (null: dx alone),
    # dbeta, scratch, stream
    "nemo_gn_relu_bwd": [_I, _I, _I] + [_P] * 11,
    # floats of scratch nemo_gn_relu_bwd needs for dgamma and dbeta at (R, C)
    "nemo_gn_relu_scratch_floats": [_I, _I],
    # backward, wgrad, C, out int[4]: K7's registers a thread, static and
    # dynamic shared memory bytes, local (spill) bytes
    "nemo_gn_relu_attributes": [_I, _I, _I, _P],
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


def _run(cmds):
    """Run the commands at the same time; raise with the output of the
    first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile the sources if their library is not built yet; returns its
    path. One nvcc per source runs in parallel, then one links. The build
    writes to a temporary directory and renames the library into place, so
    a concurrent or interrupted build never leaves a half-written library
    under the final name."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in _sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
              for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmp, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)
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


def kernel_attributes(fn: str, *args) -> dict:
    """A kernel's registers a thread, shared memory and spills (local
    memory), as the CUDA runtime reports them for the built library: the C
    function ``fn`` fills an int[4] passed after ``args``."""
    out = (ctypes.c_int * 4)()
    check(getattr(library(), fn)(*args, out), fn)
    return dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                     "local_bytes"), out))


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


def check_input(name: str, t: torch.Tensor, shape, device,
                dtype: torch.dtype = torch.float32) -> None:
    """Validate one kernel operand: of ``dtype``, contiguous, on ``device``,
    with ``shape`` (None entries match any size)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def kernel_operand(t: torch.Tensor, align: int = 4) -> torch.Tensor:
    """``t`` itself when a kernel can read it as it is (contiguous, its
    first element on an ``align``-byte boundary), else one contiguous copy,
    which PyTorch's allocator aligns. The public ops pass the caller's
    views through this; the launchers refuse what it would copy."""
    if t.is_contiguous() and t.data_ptr() % align == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)
