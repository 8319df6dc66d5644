"""Stereo depth association: left↔right feature matching + SAD subpixel.

Replaces ``Frame::ComputeStereoMatches`` (src/Frame.cc:464-641) and
``Frame::ComputeStereoFromRGBD`` (src/Frame.cc:645).  The reference builds
per-row candidate lists and loops; here the row-band, disparity-window and
level gates are masks over one dense [N_left, N_right] Hamming matrix, and
the SAD sub-pixel refinement is a batched gather + vectorized sliding
window over all matched keypoints at once.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.ops import hamming, sampling
from orbslam2_tpu.ops.extractor import Features
from orbslam2_tpu.ops.matching import TH_HIGH, TH_LOW, best_and_second

SAD_W = 5      # half window (11×11 patches, Frame.cc:554)
SAD_L = 5      # slide range ±5 (Frame.cc:565)


class StereoMatches(NamedTuple):
    u_right: jax.Array   # [N] float32, −1 where unmatched
    depth: jax.Array     # [N] float32, −1 where unmatched


def masked_median(x: jax.Array, ok: jax.Array) -> jax.Array:
    """Median of x[ok] via sort — O(n log n) but a single fused op chain
    (jnp.nanmedian's quantile interpolation measured 1.3 ms for n=1024;
    this is ~0.3 ms).  Returns +inf when nothing is valid."""
    n = x.shape[0]
    vals = jnp.sort(jnp.where(ok, x, jnp.inf))
    n_ok = jnp.sum(ok.astype(jnp.int32))
    mid = jnp.maximum(n_ok - 1, 0) // 2
    return vals[jnp.clip(mid, 0, n - 1)]


def match_stereo(
    feats_l: Features,
    feats_r: Features,
    pyr_l: List[jax.Array],
    pyr_r: List[jax.Array],
    bf: float,
    fx: float,
    scale_factor: float,
) -> StereoMatches:
    """Full stereo pipeline for one frame pair.

    Keypoint coords are raw level-0 (pre-undistortion) as in the reference,
    which matches stereo on the rectified raw images.
    """
    n_levels = len(pyr_l)
    scales = jnp.power(scale_factor, feats_r.level.astype(jnp.float32))
    uL, vL = feats_l.xy[:, 0], feats_l.xy[:, 1]
    uR, vR = feats_r.xy[:, 0], feats_r.xy[:, 1]

    # gates: row band (±2·scale of right kp), level window ±1, disparity in
    # [0, bf/minZ] with minZ = baseline ⇒ maxD = fx (Frame.cc:476-478)
    max_disp = fx
    row_ok = jnp.abs(vR[None, :] - vL[:, None]) <= 2.0 * scales[None, :]
    lvl_ok = jnp.abs(feats_r.level[None, :] - feats_l.level[:, None]) <= 1
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp >= -1.0) & (disp <= max_disp)

    d = hamming.masked_hamming_matrix(feats_l.desc, feats_l.valid,
                                      feats_r.desc, feats_r.valid)
    d = jnp.where(row_ok & lvl_ok & disp_ok, d, hamming.MAX_DIST)
    best, best_idx, _ = best_and_second(d)
    th_orb = (TH_HIGH + TH_LOW) // 2
    coarse_ok = best < th_orb

    # ---- SAD sub-pixel refinement on the keypoint's own pyramid level ----
    inv_scale_l = jnp.power(scale_factor, -feats_l.level.astype(jnp.float32))
    suL = jnp.round(uL * inv_scale_l).astype(jnp.int32)
    svL = jnp.round(vL * inv_scale_l).astype(jnp.int32)
    suR0 = jnp.round(uR[best_idx] * inv_scale_l).astype(jnp.int32)

    n = feats_l.n
    n_shifts = 2 * SAD_L + 1
    sad = jnp.zeros((n, n_shifts), jnp.float32)
    for l in range(n_levels):
        sel = feats_l.level == l
        # one-hot-matmul patch/window extraction (ops/sampling.py)
        # instead of ~1.4M-element gathers per level
        patch_l = sampling.extract_patches(pyr_l[l], suL, svL, SAD_W, SAD_W)
        win_r = sampling.extract_windows(pyr_r[l], suR0, svL, n_shifts,
                                         SAD_W, SAD_W)   # [N, 11, 11, 11]
        patch_l = patch_l - patch_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
        # brightness normalization by the COMMON center pixel (at suR0,
        # i.e. the centered window's center) rather than each window's own
        # center as in Frame.cc:567: a per-window offset injects that
        # window's center-pixel noise into the cross-window argmin and the
        # sub-pixel parabola; the common offset cancels in comparisons.
        # A/B on synthetic stereo: median |depth error| 1.04 m (common)
        # vs 1.23 m (per-window).
        center = win_r[:, SAD_L:SAD_L + 1, SAD_W:SAD_W + 1,
                       SAD_W:SAD_W + 1]                  # value at suR0
        diff = patch_l[:, None] - (win_r - center)       # [N, 11, 11, 11]
        sad_l = jnp.sum(jnp.abs(diff), axis=(2, 3))      # [N, 11]
        sad = jnp.where(sel[:, None], sad_l, sad)

    best_inc = jnp.argmin(sad, axis=-1)                  # 0..10, 5 = center
    best_sad = jnp.min(sad, axis=-1)
    interior = (best_inc > 0) & (best_inc < 2 * SAD_L)
    nn = jnp.arange(n)
    d_m1 = sad[nn, jnp.clip(best_inc - 1, 0, 2 * SAD_L)]
    d_p1 = sad[nn, jnp.clip(best_inc + 1, 0, 2 * SAD_L)]
    denom = jnp.maximum(2.0 * (d_m1 + d_p1 - 2.0 * best_sad), 1e-6)
    delta = (d_m1 - d_p1) / denom                        # parabola vertex
    delta = jnp.clip(jnp.where(interior, delta, 0.0), -1.0, 1.0)

    scale_l = jnp.power(scale_factor, feats_l.level.astype(jnp.float32))
    u_right = scale_l * (suR0.astype(jnp.float32)
                         + (best_inc - SAD_L).astype(jnp.float32) + delta)
    disparity = uL - u_right
    disparity_c = jnp.where(disparity <= 0.0, 0.01, disparity)
    u_right = jnp.where(disparity <= 0.0, uL - 0.01, u_right)

    ok = (coarse_ok & interior & feats_l.valid
          & (disparity < max_disp) & (disparity >= -1.0))

    # median-SAD outlier filter (Frame.cc:628-641): drop matches whose SAD
    # exceeds 1.5·1.4·median
    med = masked_median(best_sad, ok)   # +inf when no valid match
    ok = ok & (best_sad <= 2.1 * med)

    depth = jnp.where(ok, bf / disparity_c, -1.0)
    u_right = jnp.where(ok, u_right, -1.0)
    return StereoMatches(u_right=u_right, depth=depth)


def depth_from_rgbd(feats: Features, depth_map: jax.Array, bf: float,
                    depth_factor: float = 1.0) -> StereoMatches:
    """Frame::ComputeStereoFromRGBD (src/Frame.cc:645): look up the depth
    image at each (raw) keypoint and synthesize the virtual right coord."""
    x = jnp.round(feats.xy[:, 0]).astype(jnp.int32)
    y = jnp.round(feats.xy[:, 1]).astype(jnp.int32)
    d = depth_map.at[y, x].get(mode="clip").astype(jnp.float32)
    if depth_factor != 1.0:
        d = d / depth_factor
    ok = (d > 0) & feats.valid
    u_right = jnp.where(ok, feats.xy[:, 0] - bf / jnp.maximum(d, 1e-9), -1.0)
    depth = jnp.where(ok, d, -1.0)
    return StereoMatches(u_right=u_right, depth=depth)
