"""Image preprocessing utilities (counterpart of ``paddle_tpu.data.image``;
python/paddle/dataset/image.py analog).

Pure numpy on the host, as in the JAX package (nearest/bilinear resize
included), so the input pipeline needs no native image library; PIL is
imported only inside :func:`load_image_bytes`, to decode. Every function
takes and returns HWC uint8 or float arrays like the reference, with
``to_chw`` as the final layout flip for NCHW models.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "load_image", "load_image_bytes", "resize_short", "to_chw", "center_crop",
    "random_crop", "left_right_flip", "simple_transform", "load_and_transform",
]


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """Decode an image from raw bytes (PNG/JPEG via PIL when available)."""
    import io as _io
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ImportError("load_image_bytes needs PIL for decoding") from e
    im = Image.open(_io.BytesIO(data))
    im = im.convert("RGB" if is_color else "L")
    arr = np.asarray(im)
    return arr if is_color else arr[..., None]


def load_image(path: str, is_color: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def _resize(im: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize, pure numpy, HWC."""
    h, w = im.shape[:2]
    if (h, w) == (oh, ow):
        return im
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    imf = im.astype(np.float32)
    out = (imf[y0][:, x0] * (1 - wy) * (1 - wx) + imf[y0][:, x1] * (1 - wy) * wx
           + imf[y1][:, x0] * wy * (1 - wx) + imf[y1][:, x1] * wy * wx)
    return out.astype(im.dtype) if im.dtype == np.uint8 else out


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """image.py:180 — resize so the short side equals ``size``."""
    h, w = im.shape[:2]
    if h < w:
        return _resize(im, size, int(round(w * size / h)))
    return _resize(im, int(round(h * size / w)), size)


def to_chw(im: np.ndarray, order: Tuple[int, int, int] = (2, 0, 1)) -> np.ndarray:
    """image.py:208 — HWC → CHW."""
    return np.transpose(im, order)


def center_crop(im: np.ndarray, size: int, is_color: bool = True) -> np.ndarray:
    h, w = im.shape[:2]
    y = (h - size) // 2
    x = (w - size) // 2
    return im[y:y + size, x:x + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    y = rng.randint(0, h - size + 1)
    x = rng.randint(0, w - size + 1)
    return im[y:y + size, x:x + size]


def left_right_flip(im: np.ndarray, is_color: bool = True) -> np.ndarray:
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True,
                     mean: Optional[np.ndarray] = None) -> np.ndarray:
    """image.py:310 — the standard train/eval pipeline: resize short side,
    (random|center) crop, random flip in training, CHW, mean subtract."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2):
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean.reshape(-1, 1, 1) if mean.ndim == 1 else mean
    return im


def load_and_transform(filename: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True,
                       mean: Optional[np.ndarray] = None) -> np.ndarray:
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
