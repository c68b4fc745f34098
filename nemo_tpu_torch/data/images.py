"""Image files as ``matplotlib.pyplot.imread`` returns them, read with PIL.

The JAX package reads person masks, 16-bit Kinect depth and video frames
with ``plt.imread``; the port needs only PIL for them, since a GPU
installation may lack matplotlib. ``imread`` does what matplotlib's reader
does on top of PIL (matplotlib 3.x ``image.imread``:
``_pil_png_to_float_array`` for a PNG, ``pil_to_array`` for anything
else), so the arrays, and every value computed from them, are
the JAX path's. The two callers' conversions sit beside it: ``read_mask``
(a uint8 mask, channel 0 of a colour one) and ``read_depth`` (the stored
16-bit integers, as float32). ``read_rgb`` reads a frame as the VIBE demo
does, PIL's uint8 RGB.
"""

from __future__ import annotations

import numpy as np


def _pil():
    try:
        from PIL import Image, PngImagePlugin
    except ImportError as e:
        raise ImportError(
            "reading mask, depth and frame images needs PIL (the Pillow "
            "package), which is not installed") from e
    return Image, PngImagePlugin


def _png_float(png) -> np.ndarray:
    """A PNG as 0-1 float32, matplotlib's _pil_png_to_float_array."""
    mode, rawmode = png.mode, png.png.im_rawmode
    if rawmode == "1":
        return np.asarray(png, np.float32)
    for raw, bits in (("L;2", 2), ("L;4", 4), ("L", 8), ("I;16B", 16)):
        if rawmode == raw:
            return np.divide(png, 2 ** bits - 1, dtype=np.float32)
    if mode in ("RGB", "RGBA"):
        return np.divide(png, 2 ** 8 - 1, dtype=np.float32)
    if mode in ("P", "LA"):
        return np.divide(png.convert("RGBA"), 2 ** 8 - 1, dtype=np.float32)
    raise ValueError(f"unknown PNG rawmode {rawmode!r}")


def _pil_array(img) -> np.ndarray:
    """Any other image as an int array, matplotlib's pil_to_array."""
    if img.mode in ("RGBA", "RGBX", "RGB", "L"):
        return np.asarray(img)
    if img.mode.startswith("I;16"):
        raw = img.tobytes("raw", img.mode)
        x = np.frombuffer(raw, ">u2" if img.mode.endswith("B") else "<u2")
        return x.reshape(img.size[::-1]).astype("=u2")
    return np.asarray(img.convert("RGBA"))


def imread(path: str) -> np.ndarray:
    """``plt.imread(path)``: a PNG (by its ``.png`` suffix) as 0-1 float32,
    other formats as PIL decodes them (uint8 for a JPEG)."""
    Image, PngImagePlugin = _pil()
    if str(path).lower().endswith(".png"):
        with PngImagePlugin.PngImageFile(path) as png:
            return _png_float(png)
    with Image.open(path) as img:
        return _pil_array(img)


def read_mask(path: str) -> np.ndarray:
    """A person-segmentation mask as uint8 (H, W): channel 0 of a colour
    image, a float image times 255 and truncated (the JAX readers'
    conversion of ``plt.imread``)."""
    img = imread(path)
    if img.ndim == 3:
        img = img[..., 0]
    return (img * 255).astype(np.uint8) if img.dtype != np.uint8 else img


def read_depth(path: str) -> np.ndarray:
    """A 16-bit depth image's stored values: a 0-1 float image times
    65535.0 in float32, a uint16 one as read (the JAX depth reader's
    conversion of ``plt.imread``)."""
    img = imread(path)
    if img.dtype != np.uint16 and img.max() <= 1.0:
        img = img * 65535.0
    return img


def read_rgb(path: str) -> np.ndarray:
    """A video frame as uint8 RGB (H, W, 3), ``Image.open(path)
    .convert("RGB")``: what the JAX package's vibe_demo reads its frames
    with."""
    Image, _ = _pil()
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))
