"""Image ops: scale pyramid and Gaussian blur.

Replaces ``ORBextractor::ComputePyramid`` (src/ORBextractor.cc:921) and the
pre-descriptor ``GaussianBlur(…, Size(7,7), 2, 2)`` (src/ORBextractor.cc:900).
Everything is static-shape: per-level image sizes are Python ints derived
from the config, so XLA compiles one fused program per pyramid level.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float
                   ) -> List[Tuple[int, int]]:
    """Static (H, W) per level — level l scaled by 1/scale_factor**l."""
    return [(int(round(h / scale_factor ** l)), int(round(w / scale_factor ** l)))
            for l in range(n_levels)]


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix (align_corners=False,
    half-pixel centers — jax.image.resize 'linear' convention)."""
    scale = n_in / n_out
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(centers).astype(np.int64)
    frac = centers - lo
    lo0 = np.clip(lo, 0, n_in - 1)
    lo1 = np.clip(lo + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo0] += (1.0 - frac).astype(np.float32)
    m[np.arange(n_out), lo1] += frac.astype(np.float32)
    return m


def resize_bilinear(img: jax.Array, h2: int, w2: int) -> jax.Array:
    """[..., H, W] → [..., h2, w2] separable bilinear resize as two
    matmuls with constant interpolation matrices (jax.image.resize lowers
    to gather chains)."""
    h1, w1 = img.shape[-2], img.shape[-1]
    Ry = jnp.asarray(_resize_matrix(h2, h1))       # [h2, h1]
    Rx = jnp.asarray(_resize_matrix(w2, w1))       # [w2, w1]
    # DEFAULT precision (TF32 on the H100): pixel resize to u8-level
    # accuracy, the quantization of the reference's u8 cv::resize (the
    # framework default is "highest" for geometry,
    # orbslam2_tpu/__init__.py; frontend parity in PERF.md)
    P = jax.lax.Precision.DEFAULT
    out = jnp.einsum("ah,...hw->...aw", Ry, img, precision=P)
    return jnp.einsum("bw,...aw->...ab", Rx, out, precision=P)


def build_pyramid(img: jax.Array, n_levels: int, scale_factor: float
                  ) -> List[jax.Array]:
    """[H, W] float32 → list of n_levels arrays, level 0 = input.

    Resizes each level from the previous one with bilinear interpolation,
    mirroring the reference's level-chained cv::resize(INTER_LINEAR),
    as constant-matrix matmuls (see resize_bilinear).
    """
    h, w = img.shape[-2], img.shape[-1]
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    out = [img]
    for l in range(1, n_levels):
        out.append(resize_bilinear(out[-1], *shapes[l]))
    return out


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jax.Array, ksize: int = 7, sigma: float = 2.0
                  ) -> jax.Array:
    """Separable Gaussian blur with reflect-101 (OpenCV default) borders.

    [..., H, W] → same shape.  Implemented as 2·ksize static shifted
    slices with scalar weights — elementwise work that XLA fuses into
    one pass, where a 1-channel conv_general_dilated would pad the single
    channel.
    """
    k = _gaussian_kernel_1d(ksize, sigma)       # numpy: closure constants
    r = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    pad = [(0, 0)] * (img.ndim - 2)

    xp = jnp.pad(img, pad + [(r, r), (0, 0)], mode="reflect")
    acc = None
    for i in range(ksize):
        term = float(k[i]) * jax.lax.slice_in_dim(xp, i, i + h, axis=-2)
        acc = term if acc is None else acc + term
    xp = jnp.pad(acc, pad + [(0, 0), (r, r)], mode="reflect")
    acc = None
    for i in range(ksize):
        term = float(k[i]) * jax.lax.slice_in_dim(xp, i, i + w, axis=-1)
        acc = term if acc is None else acc + term
    return acc


def to_grayscale(img: jax.Array, rgb_order: bool = True) -> jax.Array:
    """[..., H, W, 3] uint8/float → [..., H, W] float32 grayscale.

    Matches cv::cvtColor's BT.601 weights used by Tracking::GrabImage*
    (src/Tracking.cc:269-294).
    """
    img = img.astype(jnp.float32)
    if img.ndim >= 3 and img.shape[-1] == 3:
        w = (0.299, 0.587, 0.114) if rgb_order else (0.114, 0.587, 0.299)
        return (img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2])
    return img
