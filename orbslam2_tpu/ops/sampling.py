"""Gather-free patch extraction and point sampling via one-hot matmuls.

Per-keypoint patch reads (IC-angle moments, rotated-BRIEF samples,
stereo SAD windows) are written as selection-matrix contractions instead
of scattered gathers:

    patch[n] = R(n) @ img @ C(n)ᵀ

with R(n) = one-hot row-selector [rows, H] and C(n) = one-hot column-
selector [cols, W] built on the fly from keypoint coordinates (two iota
compares).  A 1024-keypoint 45×45 extraction is ~8 GFLOP of dense matmul
work.  Gather vs matmul time on the H100: not measured.

Point sampling from per-keypoint patches (rotated BRIEF) follows the same
pattern one level down: one-hot selectors over the patch rows/cols.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Pixel-domain one-hot matmuls opt out of the framework-wide "highest"
# default (orbslam2_tpu/__init__.py).  On the H100 DEFAULT runs f32 dots
# as TF32 (10-bit mantissa): the 0/1 selectors are exact and the sums
# accumulate in f32, so only the pixel values round.  The stereo
# frontend's GPU-vs-CPU parity under this setting is in PERF.md.
_PIX = jax.lax.Precision.DEFAULT


def _onehot_rows(idx: jax.Array, size: int, dtype=jnp.float32) -> jax.Array:
    """[..., k] int32 indices → [..., k, size] one-hot (out-of-range rows
    are all-zero, which the callers pre-empt by clamping)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, idx.shape + (size,),
                                    idx.ndim)
    return (iota == idx[..., None]).astype(dtype)


def extract_patches(img: jax.Array, cx: jax.Array, cy: jax.Array,
                    half_h: int, half_w: int) -> jax.Array:
    """[H, W] image + integer centers [n] → [n, 2·half_h+1, 2·half_w+1].

    Centers are clamped so the window stays in bounds (the callers only
    request patches around interior keypoints; for stereo the reference
    clamps/skips border candidates the same way)."""
    h, w = img.shape
    rows = 2 * half_h + 1
    cols = 2 * half_w + 1
    cyc = jnp.clip(cy, half_h, h - 1 - half_h)
    cxc = jnp.clip(cx, half_w, w - 1 - half_w)
    ridx = cyc[:, None] + jnp.arange(-half_h, half_h + 1)[None, :]   # [n, R]
    cidx = cxc[:, None] + jnp.arange(-half_w, half_w + 1)[None, :]   # [n, C]
    R = _onehot_rows(ridx, h, img.dtype)            # [n, R, H]
    C = _onehot_rows(cidx, w, img.dtype)            # [n, C, W]
    strips = jnp.einsum("nrh,hw->nrw", R, img, precision=_PIX)      # [n, R, W]
    return jnp.einsum("nrw,ncw->nrc", strips, C, precision=_PIX)    # [n, R, C]


def extract_windows(img: jax.Array, cx: jax.Array, cy: jax.Array,
                    n_shifts: int, half_h: int, half_w: int) -> jax.Array:
    """[H, W] + centers [n] → [n, n_shifts, R, C] where shift s re-centers
    the column window at cx + s − n_shifts//2 (stereo SAD candidates).

    One patch extraction of width C + n_shifts − 1, then a constant
    selection einsum fans out the shifted windows."""
    half_l = n_shifts // 2
    wide = extract_patches(img, cx, cy, half_h, half_w + half_l)
    cols = 2 * half_w + 1
    # sel[s, j, c] = 1 iff c == s + j  (constant, folded at compile time)
    s_i = jax.lax.broadcasted_iota(jnp.int32, (n_shifts, cols,
                                               cols + n_shifts - 1), 0)
    j_i = jax.lax.broadcasted_iota(jnp.int32, (n_shifts, cols,
                                               cols + n_shifts - 1), 1)
    c_i = jax.lax.broadcasted_iota(jnp.int32, (n_shifts, cols,
                                               cols + n_shifts - 1), 2)
    sel = (c_i == s_i + j_i).astype(img.dtype)
    return jnp.einsum("nrc,sjc->nsrj", wide, sel, precision=_PIX)


def sample_points(patches: jax.Array, px: jax.Array, py: jax.Array
                  ) -> jax.Array:
    """Per-keypoint point sampling: patches [n, R, C], integer in-patch
    coordinates px/py [n, S] → values [n, S].

    value[n, s] = Σ_rc onehot(py)[n,s,r] · patch[n,r,c] · onehot(px)[n,s,c]
    — two batched contractions instead of an n·S-element gather."""
    n, R, C = patches.shape
    pyc = jnp.clip(py, 0, R - 1)
    pxc = jnp.clip(px, 0, C - 1)
    Pr = _onehot_rows(pyc, R, patches.dtype)        # [n, S, R]
    Pc = _onehot_rows(pxc, C, patches.dtype)        # [n, S, C]
    t = jnp.einsum("nsr,nrc->nsc", Pr, patches, precision=_PIX)
    return jnp.einsum("nsc,nsc->ns", t, Pc, precision=_PIX)
