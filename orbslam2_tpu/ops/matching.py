"""Data-association kernels: all of ``ORBmatcher`` (src/ORBmatcher.cc),
re-designed dense.

The reference accelerates candidate search with a 64×48 feature grid
(``Frame::GetFeaturesInArea``) and BoW feature-vector node alignment
(``SearchByFboW``) because a CPU cannot afford brute force.  On an
accelerator the idiomatic design is the opposite: compute the full
[points × keypoints] Hamming-distance matrix (XOR+popcount,
ops/hamming.py) and apply window / level / epipolar gates as elementwise
masks — exact search, no candidate pruning, one fused pass.  Match-index
outputs are fixed-shape int32 arrays with −1 sentinels.

Constants TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 (ORBmatcher.cc:35-37).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.ops import hamming
from orbslam2_tpu.utils import camera as cam_mod
from orbslam2_tpu.utils import lie

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
NO_MATCH = -1
_INF = jnp.float32(1e30)


# ------------------------------------------------------------- utilities ----

def predict_scale(dist: jax.Array, max_dist: jax.Array, scale_factor: float,
                  n_levels: int) -> jax.Array:
    """MapPoint::PredictScale (src/MapPoint.cc:385): log-ratio → level."""
    ratio = max_dist / jnp.maximum(dist, 1e-9)
    lvl = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(scale_factor))
    return jnp.clip(lvl.astype(jnp.int32), 0, n_levels - 1)


def best_and_second(dist: jax.Array, axis: int = -1
                    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per row: (best distance, best index, second-best distance) where the
    second-best excludes the best column (matcher ratio-test semantics)."""
    best = jnp.min(dist, axis=axis)
    best_idx = jnp.argmin(dist, axis=axis)
    masked = jnp.where(
        jax.nn.one_hot(best_idx, dist.shape[axis], dtype=bool, axis=axis),
        hamming.MAX_DIST, dist)
    second = jnp.min(masked, axis=axis)
    return best, best_idx, second


def rotation_consistency_mask(angle_a: jax.Array, angle_b_matched: jax.Array,
                              match_ok: jax.Array) -> jax.Array:
    """Rotation-histogram check (ORBmatcher::ComputeThreeMaxima,
    src/ORBmatcher.cc:1597): keep only matches whose orientation difference
    falls in the 3 dominant bins of a 30-bin histogram."""
    dtheta = (angle_a - angle_b_matched) % (2.0 * jnp.pi)
    bins = (dtheta * (HISTO_LENGTH / (2.0 * jnp.pi))).astype(jnp.int32)
    bins = jnp.clip(bins, 0, HISTO_LENGTH - 1)
    hist = jnp.sum(
        jax.nn.one_hot(bins, HISTO_LENGTH, dtype=jnp.int32)
        * match_ok[:, None].astype(jnp.int32), axis=0)
    # top-3 bins; reference drops bin 2/3 if much weaker than max
    top3_vals, top3_idx = jax.lax.top_k(hist, 3)
    keep2 = top3_vals[1] > 0.1 * top3_vals[0]
    keep3 = top3_vals[2] > 0.1 * top3_vals[0]
    ok_bin = ((bins == top3_idx[0])
              | ((bins == top3_idx[1]) & keep2)
              | ((bins == top3_idx[2]) & keep3))
    return match_ok & ok_bin


def resolve_duplicates(match_idx: jax.Array, match_dist: jax.Array,
                       n_targets: int) -> jax.Array:
    """Enforce one source per target: among sources matched to the same
    target keep only the lowest-distance one (the reference's bookkeeping
    of already-matched keypoints, done densely with a scatter-min)."""
    ok = match_idx >= 0
    tgt = jnp.where(ok, match_idx, 0)
    best_per_tgt = jnp.full((n_targets,), hamming.MAX_DIST + 1, jnp.int32)
    best_per_tgt = best_per_tgt.at[tgt].min(
        jnp.where(ok, match_dist, hamming.MAX_DIST + 1))
    # a source survives iff it attains the min for its target; break ties
    # by lowest source index
    attains = ok & (match_dist == best_per_tgt[tgt])
    n_src = match_idx.shape[0]
    src_ids = jnp.arange(n_src, dtype=jnp.int32)
    first_src = jnp.full((n_targets,), n_src, jnp.int32)
    first_src = first_src.at[tgt].min(jnp.where(attains, src_ids, n_src))
    survives = attains & (first_src[tgt] == src_ids)
    return jnp.where(survives, match_idx, NO_MATCH)


# --------------------------------------------- projection-guided matching ----

class ProjectionQuery(NamedTuple):
    """A batch of 3D points to be matched into a frame by projection.

    min_dist/max_dist are the RAW scale-invariance bounds (MapPoint
    mfMin/MaxDistance) — search_by_projection applies the 0.8/1.2 frustum
    slack itself, while scale prediction uses the raw max (the reference's
    PredictScale, MapPoint.cc:385, takes mfMaxDistance unslackened;
    pre-slackening here biased every predicted level +1)."""

    pos_w: jax.Array       # [P, 3]
    normal: jax.Array      # [P, 3]
    min_dist: jax.Array    # [P]
    max_dist: jax.Array    # [P]
    desc: jax.Array        # [P, 8] uint32
    valid: jax.Array       # [P] bool


def search_by_projection(
    cam: cam_mod.Camera,
    Tcw: jax.Array,
    query: ProjectionQuery,
    kp_xy: jax.Array,          # [N, 2] undistorted keypoint coords
    kp_level: jax.Array,       # [N]
    kp_desc: jax.Array,        # [N, 8]
    kp_valid: jax.Array,       # [N]
    kp_ur: jax.Array,          # [N] right-coords or −1 (mono kp)
    scale_factor: float,
    n_levels: int,
    radius: float,             # base window th (reference th param)
    nn_ratio: float,
    view_cos_limit: float = 0.5,
    check_ur: bool = False,
    level_lo_off: int = -1,    # candidate level window around predicted
    level_hi_off: int = 1,
    th_dist: int = TH_HIGH,    # Hamming acceptance (Fuse uses TH_LOW)
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """ORBmatcher::SearchByProjection frame↔local-map overload
    (src/ORBmatcher.cc:43-135): project each query point, gate keypoints by
    window radius (scaled by predicted level, widened ×4 for low view-cos),
    by pyramid-level window, then best+second Hamming with ratio test.

    Returns (point→kp index [P], distances [P], per-point proj uv [P,2]).
    Duplicates are NOT resolved here — call resolve_duplicates.
    """
    visible, uv, ur, dist, view_cos = cam_mod.in_frustum(
        cam, Tcw, query.pos_w, 0.8 * query.min_dist, 1.2 * query.max_dist,
        query.normal, view_cos_limit)
    visible = visible & query.valid
    pred_lvl = predict_scale(dist, query.max_dist, scale_factor, n_levels)
    scale_of = jnp.power(scale_factor, pred_lvl.astype(jnp.float32))
    r = jnp.where(view_cos > 0.998, 2.5, 4.0) * (radius / 4.0)
    win = r * scale_of                                     # [P]

    du = jnp.abs(uv[:, 0:1] - kp_xy[None, :, 0])           # [P, N]
    dv = jnp.abs(uv[:, 1:2] - kp_xy[None, :, 1])
    in_win = (du < win[:, None]) & (dv < win[:, None])
    lvl_ok = ((kp_level[None, :] >= pred_lvl[:, None] + level_lo_off)
              & (kp_level[None, :] <= pred_lvl[:, None] + level_hi_off))
    gate = in_win & lvl_ok & kp_valid[None, :] & visible[:, None]
    if check_ur:
        # stereo: also gate on right-coordinate reprojection (:116-121)
        dur = jnp.abs(ur[:, None] - kp_ur[None, :])
        gate = gate & ((kp_ur[None, :] < 0) | (dur < win[:, None]))

    d = hamming.hamming_matrix(query.desc, kp_desc)
    d = jnp.where(gate, d, hamming.MAX_DIST)
    best, best_idx, second = best_and_second(d)
    ok = (best <= th_dist) & (best < nn_ratio * second.astype(jnp.float32))
    return jnp.where(ok, best_idx, NO_MATCH), best, uv


def match_descriptors(
    desc_a: jax.Array, valid_a: jax.Array,
    desc_b: jax.Array, valid_b: jax.Array,
    nn_ratio: float = 0.7,
    th: int = TH_LOW,
    angle_a: Optional[jax.Array] = None,
    angle_b: Optional[jax.Array] = None,
    check_rotation: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Brute-force descriptor matching a→b with ratio test + rotation
    histogram.  Exact-search replacement for ``SearchByFboW``
    (src/ORBmatcher.cc:157,517) — the BoW node alignment there is a CPU
    pruning heuristic; dense Hamming gives strictly better recall.

    Returns (a→b index [A], distance [A]).
    """
    d = hamming.masked_hamming_matrix(desc_a, valid_a, desc_b, valid_b)
    best, best_idx, second = best_and_second(d)
    ok = ((best <= th) & (best < nn_ratio * second.astype(jnp.float32))
          & valid_a)
    if check_rotation and angle_a is not None:
        ok = rotation_consistency_mask(angle_a, angle_b[best_idx], ok)
    match = jnp.where(ok, best_idx, NO_MATCH)
    match = resolve_duplicates(match, best, desc_b.shape[0])
    return match, best


def search_for_initialization(
    xy_a: jax.Array, desc_a: jax.Array, valid_a: jax.Array, level_a: jax.Array,
    xy_b: jax.Array, desc_b: jax.Array, valid_b: jax.Array, level_b: jax.Array,
    angle_a: jax.Array, angle_b: jax.Array,
    window: float = 100.0,
    nn_ratio: float = 0.9,
) -> Tuple[jax.Array, jax.Array]:
    """ORBmatcher::SearchForInitialization (src/ORBmatcher.cc:400): windowed
    level-0 matching between the two bootstrap frames."""
    d = hamming.masked_hamming_matrix(desc_a, valid_a, desc_b, valid_b)
    du = jnp.abs(xy_a[:, 0:1] - xy_b[None, :, 0])
    dv = jnp.abs(xy_a[:, 1:2] - xy_b[None, :, 1])
    gate = ((du < window) & (dv < window)
            & (level_a[:, None] == 0) & (level_b[None, :] == 0))
    d = jnp.where(gate, d, hamming.MAX_DIST)
    best, best_idx, second = best_and_second(d)
    ok = (best <= TH_LOW) & (best < nn_ratio * second.astype(jnp.float32))
    ok = rotation_consistency_mask(angle_a, angle_b[best_idx], ok)
    match = jnp.where(ok, best_idx, NO_MATCH)
    match = resolve_duplicates(match, best, desc_b.shape[0])
    return match, best


def search_for_triangulation(
    cam: cam_mod.Camera,
    T1w: jax.Array, T2w: jax.Array,
    kp1_xy: jax.Array, kp1_level: jax.Array, kp1_desc: jax.Array,
    kp1_free: jax.Array,
    kp2_xy: jax.Array, kp2_level: jax.Array, kp2_desc: jax.Array,
    kp2_free: jax.Array,
    angle1: jax.Array, angle2: jax.Array,
    sigma2: jax.Array,          # [n_levels] per-level sigma² table
    coarse: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """ORBmatcher::SearchForTriangulation (src/ORBmatcher.cc:652): match
    unassociated features across two keyframes under the epipolar
    constraint; also rejects points too close to the epipole in KF1→KF2.

    Returns (kp1→kp2 index [N1], distance [N1]).
    """
    # relative pose 2←1 and fundamental matrix F12 = K2⁻ᵀ [t]× R K1⁻¹
    # (LocalMapping::ComputeF12, src/LocalMapping.cc:533)
    T21 = T2w @ lie.se3_inv(T1w)
    R21, t21 = lie.mat_to_rt(T21)
    Kinv = jnp.linalg.inv(cam.K)
    F12 = Kinv.T @ lie.hat(t21) @ R21 @ Kinv

    ones1 = jnp.ones_like(kp1_xy[:, :1])
    p1 = jnp.concatenate([kp1_xy, ones1], axis=-1)          # [N1, 3]
    lines = p1 @ F12.T                                      # [N1, 3] epilines in im2
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * kp2_xy[None, :, 0] + b * kp2_xy[None, :, 1] + c
    den = a * a + b * b
    dsq = (num * num) / jnp.maximum(den, 1e-12)             # [N1, N2]
    sigma2 = jnp.asarray(sigma2)      # accept numpy closure-constant tables
    ep_ok = dsq < 3.84 * sigma2[kp2_level][None, :]

    # epipole of camera-1 center in image 2 — skip kp2 too close to it (:700)
    C1 = -jnp.swapaxes(T1w[:3, :3], -1, -2) @ T1w[:3, 3]
    e2_uv, e2_z = cam_mod.project_world(cam, T2w, C1)
    de = jnp.sum((kp2_xy - e2_uv) ** 2, axis=-1)
    lvl_scale2 = sigma2[kp2_level]
    epipole_ok = de >= 100.0 * lvl_scale2

    d = hamming.masked_hamming_matrix(kp1_desc, kp1_free, kp2_desc, kp2_free)
    gate = ep_ok & epipole_ok[None, :]
    d = jnp.where(gate, d, hamming.MAX_DIST)
    best, best_idx, second = best_and_second(d)
    ok = best <= TH_LOW
    if not coarse:
        ok = rotation_consistency_mask(angle1, angle2[best_idx], ok)
    match = jnp.where(ok, best_idx, NO_MATCH)
    match = resolve_duplicates(match, best, kp2_desc.shape[0])
    return match, best
