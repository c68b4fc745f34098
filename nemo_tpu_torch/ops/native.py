"""ctypes bindings for the framework-free C++ host code in
``native/nemo_native.cpp`` (port of nemo_tpu/ops/native.py).

The library is host code, not a device kernel: a brute-force one-way
nearest neighbour and a batch OpenPose JSON parser for the preprocessing
path. It is compiled with ``g++ -O3`` at first use into
``build/nemo_tpu_torch/`` (the directory the CUDA kernels build into),
named by a hash of the source and of the CPU that ``-march=native``
resolves to, so an edited source, or a checkout copied to another machine,
rebuilds it. The source
is looked up at ``native/nemo_native.cpp`` beside the package directory (a
checkout's root). Without the source or a compiler, :func:`get_native`
returns None and the callers take their Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from ._build import BUILD_DIR

SOURCE = osp.join(osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))), "native", "nemo_native.cpp")

_lib: Optional[ctypes.CDLL] = None
_tried = False


FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def _native_arch() -> bytes:
    """g++'s resolution of -march=native on this machine (empty without
    g++)."""
    try:
        out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             check=True, capture_output=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return b""
    return b"".join(line.strip() for line in out.splitlines()
                    if line.strip().startswith((b"-march=", b"-mtune=")))


def library_file() -> str:
    """The path the library for the current source and CPU builds to."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + _native_arch())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return osp.join(BUILD_DIR, f"libnemo_native_{h.hexdigest()[:16]}.so")


def build_native(force: bool = False) -> Optional[str]:
    """Compile the native library; returns its path, or None without the
    source or a working g++. The object is written under a temporary name
    and renamed into place, so processes building at once never load a
    half-written file."""
    if not osp.exists(SOURCE):
        return None
    so = library_file()
    if osp.exists(so) and not force:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if osp.exists(tmp):
            os.remove(tmp)


def get_native() -> Optional[ctypes.CDLL]:
    """The loaded library (built on the first call), or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.chamfer_forward.argtypes = [f32p, f32p, ctypes.c_int64,
                                    ctypes.c_int64, f32p, i32p]
    lib.chamfer_forward.restype = None
    lib.parse_openpose_batch.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_int, f32p]
    lib.parse_openpose_batch.restype = ctypes.c_int64
    _lib = lib
    return _lib


def chamfer_forward_native(a: np.ndarray, b: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """For each of a's (N, 3) points, the squared distance to and index of
    its nearest point in b (M, 3), on the host."""
    lib = get_native()
    if lib is None:
        raise RuntimeError("native library unavailable")
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    dist = np.empty(a.shape[0], np.float32)
    idx = np.empty(a.shape[0], np.int32)
    lib.chamfer_forward(a, b, a.shape[0], b.shape[0], dist, idx)
    return dist, idx


def parse_openpose_batch_native(paths: List[str], person: int = 0
                                ) -> np.ndarray:
    """Parse many OpenPose JSONs -> (N, 25, 3); zeros for a frame without
    that person."""
    lib = get_native()
    if lib is None:
        raise RuntimeError("native library unavailable")
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.zeros((len(paths), 25, 3), np.float32)
    lib.parse_openpose_batch(blob, len(paths), person, out)
    return out
