"""joblib's pickle files, read and written without joblib.

The reference stores its VIBE, PARE and GLAMR outputs, MoSh mocap, GT 2D
keypoints and re-fitted GT cameras with ``joblib.dump``: a pickle stream in
which each numpy array is a ``joblib.numpy_pickle.NumpyArrayWrapper`` object
(subclass, shape, order, dtype) followed at once by the array itself: one
byte giving a padding length, that many padding bytes so the data starts
16-byte aligned, then the raw data (an object array: a pickle of it). The
port's CUDA machine has no joblib, so :func:`load` and :func:`dump` handle
that format themselves; a plain pickle loads too. A compressed joblib file
(``joblib.dump(..., compress=...)``, which the reference does not write)
needs joblib, and is handed to it when it is installed.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np

ALIGNMENT = 16          # joblib's NUMPY_ARRAY_ALIGNMENT_BYTES
_WRAPPER = ("joblib.numpy_pickle", "NumpyArrayWrapper")
# first bytes of joblib's compressed files (zlib, gzip, bz2, lzma, xz, lz4)
_COMPRESSED = (b"ZF", b"\x78", b"\x1f\x8b", b"BZ", b"\x5d\x00",
               b"\xfd\x37\x7a\x58\x5a", b"\x04\x22\x4d\x18")


class NumpyArrayWrapper:
    """joblib's record of an array written after it in the stream (the same
    fields, pickled under joblib's class name)."""

    def __init__(self, subclass, shape, order, dtype, allow_mmap=False,
                 numpy_array_alignment_bytes=ALIGNMENT):
        self.subclass = subclass
        self.shape = shape
        self.order = order
        self.dtype = dtype
        self.allow_mmap = allow_mmap
        self.numpy_array_alignment_bytes = numpy_array_alignment_bytes

    def read(self, f) -> np.ndarray:
        if self.dtype.hasobject:
            return pickle.load(f)
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            f.read(int.from_bytes(f.read(1), "little"))
        count = int(np.prod(self.shape, dtype=np.int64))
        size = count * self.dtype.itemsize
        data = f.read(size)
        if len(data) != size:
            raise EOFError("joblib pickle: array data cut short")
        array = np.frombuffer(data, dtype=self.dtype, count=count).copy()
        if self.order == "F":
            array = array.reshape(self.shape[::-1]).transpose()
        else:
            array = array.reshape(self.shape)
        if not array.dtype.isnative:
            array = array.astype(array.dtype.newbyteorder("="))
        return array

    def write(self, array: np.ndarray, f) -> None:
        if array.dtype.hasobject:
            pickle.dump(array, f, protocol=5)
            return
        padding = ALIGNMENT - (f.tell() + 1) % ALIGNMENT
        f.write(padding.to_bytes(1, "little") + b"\xff" * padding)
        f.write(array.tobytes(order=self.order))


class _Unpickler(pickle._Unpickler):
    """The pure-Python unpickler, reading each array right after the BUILD
    of its wrapper (joblib's NumpyUnpickler.load_build)."""

    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, f):
        super().__init__(f)
        self.file_handle = f

    def find_class(self, module, name):
        if (module, name) == _WRAPPER:
            return NumpyArrayWrapper
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], NumpyArrayWrapper):
            self.stack.append(self.stack.pop().read(self.file_handle))

    dispatch[pickle.BUILD[0]] = load_build


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing each ndarray as joblib does: its
    wrapper, the frame closed, then the array (NumpyPickler.save)."""

    def __init__(self, f):
        super().__init__(f, protocol=pickle.DEFAULT_PROTOCOL)
        self.file_handle = f

    def save(self, obj, save_persistent_id=True):
        if type(obj) is np.ndarray:
            order = "F" if obj.flags.f_contiguous and \
                not obj.flags.c_contiguous else "C"
            wrapper = NumpyArrayWrapper(np.ndarray, obj.shape, order,
                                        obj.dtype,
                                        allow_mmap=not obj.dtype.hasobject)
            super().save(wrapper)
            if self.proto >= 4:
                self.framer.commit_frame(force=True)
            wrapper.write(obj, self.file_handle)
            return
        super().save(obj, save_persistent_id)

    def save_global(self, obj, name=None):
        if obj is not NumpyArrayWrapper:
            return super().save_global(obj, name)
        module, name = _WRAPPER
        if self.proto >= 4:
            self.save(module)
            self.save(name)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{name}\n".encode())
        self.memoize(obj)


def load(path: str) -> Any:
    """What ``joblib.load(path)`` returns, for an uncompressed joblib file or
    a plain pickle."""
    with open(path, "rb") as f:
        if f.read(6).startswith(_COMPRESSED):
            import joblib      # compressed: joblib's own reader
            return joblib.load(path)
        f.seek(0)
        return _Unpickler(f).load()


def dump(obj: Any, path: str) -> str:
    """Write obj as ``joblib.dump(obj, path)`` does (uncompressed)."""
    with open(path, "wb") as f:
        _Pickler(f).dump(obj)
    return path
