"""The map as fixed-capacity device arrays with functional updates.

Replaces the reference's pointer-graph data model — ``Map`` (src/Map.cc),
``KeyFrame`` (src/KeyFrame.cc), ``MapPoint`` (src/MapPoint.cc) — and its
mutex web (``mMutexMapUpdate``, per-object mutexes; SURVEY.md §5 "race
detection") with immutable array state: every update returns a new MapState
(XLA aliases the buffers, so this costs a scatter, not a copy).

Design mapping:
  KeyFrame objects        → rows of kf_* arrays, liveness in kf_valid
  MapPoint objects        → rows of mp_* arrays, liveness in mp_valid
  mObservations (MP→KF)   → the inverse map kf_mp [K, N] (feature → MP id);
                            observation lists are recovered densely
  covisibility graph      → computed on demand: one [K,P]×[P,K] bool matmul
                            (KeyFrame::UpdateConnections, KeyFrame.cc:284,
                            becomes a matmul instead of map iteration)
  spanning tree           → kf_parent [K]
  SetBadFlag / Replace    → mask writes + index redirection
  normal/depth statistics → incremental sums (UpdateNormalAndDepth,
                            MapPoint.cc:330, without revisiting history)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.config import SlamConfig
from orbslam2_tpu.ops import matching
from orbslam2_tpu.utils import lie

NO_MP = -1
DESC_RING = 4   # recent observation descriptors kept per map point


class MapState(NamedTuple):
    # ----- keyframes [K, ...] -----
    kf_pose: jax.Array        # [K, 4, 4] Tcw
    kf_valid: jax.Array       # [K] bool
    kf_frame_id: jax.Array    # [K] int32 source frame id
    kf_timestamp: jax.Array   # [K] float64-as-float32 seconds
    kf_xy: jax.Array          # [K, N, 2] undistorted coords
    kf_level: jax.Array       # [K, N] int32
    kf_angle: jax.Array       # [K, N] float32
    kf_desc: jax.Array        # [K, N, 8] uint32
    kf_kp_valid: jax.Array    # [K, N] bool
    kf_ur: jax.Array          # [K, N] float32
    kf_depth: jax.Array       # [K, N] float32
    kf_mp: jax.Array          # [K, N] int32 feature→map-point (−1 none)
    kf_parent: jax.Array      # [K] int32 spanning-tree parent (−1 root)
    # ----- map points [P, ...] -----
    mp_pos: jax.Array         # [P, 3]
    mp_valid: jax.Array       # [P] bool
    mp_desc: jax.Array        # [P, 8] uint32 representative descriptor
    mp_desc_ring: jax.Array   # [P, DESC_RING, 8] recent obs descriptors
    mp_desc_n: jax.Array      # [P] int32 descriptors ever stored
    mp_normal_sum: jax.Array  # [P, 3] running sum of unit viewing rays
    mp_n_obs: jax.Array       # [P] int32 observation count
    mp_min_dist: jax.Array    # [P] scale-invariance band (unslackened)
    mp_max_dist: jax.Array    # [P]
    mp_ref_kf: jax.Array      # [P] int32 reference keyframe
    mp_first_kf: jax.Array    # [P] int32 (culling bookkeeping)
    mp_visible: jax.Array     # [P] int32 IncreaseVisible counter
    mp_found: jax.Array       # [P] int32 IncreaseFound counter

    @property
    def K(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def N(self) -> int:
        return self.kf_xy.shape[1]

    @property
    def P(self) -> int:
        return self.mp_pos.shape[0]

    # convenience views ----------------------------------------------------
    def mp_normal(self) -> jax.Array:
        s = self.mp_normal_sum
        return s / jnp.maximum(jnp.linalg.norm(s, axis=-1, keepdims=True), 1e-9)

    def kf_center(self) -> jax.Array:
        """[K, 3] camera centers Ow = −Rᵀt."""
        R = self.kf_pose[:, :3, :3]
        t = self.kf_pose[:, :3, 3]
        return -jnp.einsum("kji,kj->ki", R, t)


def empty_map(cfg: SlamConfig, dtype=jnp.float32) -> MapState:
    K = cfg.capacity.max_keyframes
    N = cfg.orb.n_features_padded
    P = cfg.capacity.max_map_points
    return MapState(
        kf_pose=jnp.tile(jnp.eye(4, dtype=dtype), (K, 1, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_frame_id=jnp.zeros(K, jnp.int32),
        kf_timestamp=jnp.zeros(K, dtype),
        kf_xy=jnp.zeros((K, N, 2), dtype),
        kf_level=jnp.zeros((K, N), jnp.int32),
        kf_angle=jnp.zeros((K, N), dtype),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_kp_valid=jnp.zeros((K, N), bool),
        kf_ur=jnp.full((K, N), -1.0, dtype),
        kf_depth=jnp.full((K, N), -1.0, dtype),
        kf_mp=jnp.full((K, N), NO_MP, jnp.int32),
        kf_parent=jnp.full((K,), -1, jnp.int32),
        mp_pos=jnp.zeros((P, 3), dtype),
        mp_valid=jnp.zeros(P, bool),
        mp_desc=jnp.zeros((P, 8), jnp.uint32),
        mp_desc_ring=jnp.zeros((P, DESC_RING, 8), jnp.uint32),
        mp_desc_n=jnp.zeros(P, jnp.int32),
        mp_normal_sum=jnp.zeros((P, 3), dtype),
        mp_n_obs=jnp.zeros(P, jnp.int32),
        mp_min_dist=jnp.zeros(P, dtype),
        mp_max_dist=jnp.zeros(P, dtype),
        mp_ref_kf=jnp.zeros(P, jnp.int32),
        mp_first_kf=jnp.zeros(P, jnp.int32),
        mp_visible=jnp.zeros(P, jnp.int32),
        mp_found=jnp.zeros(P, jnp.int32),
    )


# ------------------------------------------------------------ keyframes ----

def add_keyframe(ms: MapState, slot: jax.Array, Tcw: jax.Array,
                 frame_id: jax.Array, timestamp: jax.Array,
                 xy, level, angle, desc, kp_valid, ur, depth,
                 kp_mp: jax.Array, parent: jax.Array) -> MapState:
    """Write a keyframe into row ``slot`` (KeyFrame ctor, KeyFrame.cc:31)."""
    return ms._replace(
        kf_pose=ms.kf_pose.at[slot].set(Tcw),
        kf_valid=ms.kf_valid.at[slot].set(True),
        kf_frame_id=ms.kf_frame_id.at[slot].set(frame_id),
        kf_timestamp=ms.kf_timestamp.at[slot].set(timestamp),
        kf_xy=ms.kf_xy.at[slot].set(xy),
        kf_level=ms.kf_level.at[slot].set(level),
        kf_angle=ms.kf_angle.at[slot].set(angle),
        kf_desc=ms.kf_desc.at[slot].set(desc),
        kf_kp_valid=ms.kf_kp_valid.at[slot].set(kp_valid),
        kf_ur=ms.kf_ur.at[slot].set(ur),
        kf_depth=ms.kf_depth.at[slot].set(depth),
        kf_mp=ms.kf_mp.at[slot].set(kp_mp),
        kf_parent=ms.kf_parent.at[slot].set(parent),
    )


def add_observations(ms: MapState, kf: jax.Array, feat_idx: jax.Array,
                     mp_idx: jax.Array, ok: jax.Array,
                     scale_factor: float, n_levels: int) -> MapState:
    """Associate features of keyframe ``kf`` with map points and update the
    incremental observation statistics (MapPoint::AddObservation +
    UpdateNormalAndDepth, MapPoint.cc:98,330).

    feat_idx/mp_idx/ok are parallel arrays (padded; ok=False rows ignored).
    """
    # masked rows are redirected out of bounds — JAX drops OOB scatter
    # writes, so there are no collisions with real targets
    mp_safe = jnp.where(ok, mp_idx, 0)          # for gathers only
    mp_oob = jnp.where(ok, mp_idx, ms.P)        # for set-scatters
    f_oob = jnp.where(ok, feat_idx, ms.N)
    f_safe = jnp.where(ok, feat_idx, 0)
    kf_mp = ms.kf_mp.at[kf, f_oob].set(mp_idx)

    center = ms.kf_center()[kf]
    ray = ms.mp_pos[mp_safe] - center
    dist = jnp.linalg.norm(ray, axis=-1)
    unit = ray / jnp.maximum(dist[:, None], 1e-9)
    okf = ok.astype(ms.mp_pos.dtype)[:, None]

    normal_sum = ms.mp_normal_sum.at[mp_safe].add(unit * okf)
    # stereo observations count double (MapPoint::AddObservation increments
    # nObs by 2 when mvuRight ≥ 0) — the culling thresholds depend on this
    inc = jnp.where(ms.kf_ur[kf, f_safe] >= 0, 2, 1)
    n_obs = ms.mp_n_obs.at[mp_safe].add(jnp.where(ok, inc, 0))
    # scale band from this observation
    lvl = ms.kf_level[kf, f_safe].astype(ms.mp_pos.dtype)
    maxd = dist * jnp.power(scale_factor, lvl)
    mind = maxd / (scale_factor ** (n_levels - 1))
    max_dist = ms.mp_max_dist.at[mp_oob].set(maxd)
    min_dist = ms.mp_min_dist.at[mp_oob].set(mind)

    # distinctive descriptor (MapPoint::ComputeDistinctiveDescriptors,
    # MapPoint.cc:242): among the stored observation descriptors, pick the
    # one with minimum median Hamming distance to the others.  The
    # reference scans ALL observations; we keep a DESC_RING-deep ring of
    # the most recent ones (bounded state, same selection rule).
    new_desc = ms.kf_desc[kf, f_safe]                   # [n, 8]
    cnt = ms.mp_desc_n[mp_safe]                         # [n]
    ring_pos = cnt % DESC_RING
    ring = ms.mp_desc_ring.at[mp_oob, ring_pos].set(new_desc)
    desc_n = ms.mp_desc_n.at[mp_oob].add(1)

    cand = ring[mp_safe]                                # [n, R, 8]
    n_stored = jnp.minimum(cnt + 1, DESC_RING)          # [n]
    slot_ok = (jnp.arange(DESC_RING)[None, :]
               < n_stored[:, None])                     # [n, R]
    dmat = jnp.sum(jax.lax.population_count(
        cand[:, :, None, :] ^ cand[:, None, :, :]), axis=-1)  # [n, R, R]
    big = jnp.int32(1 << 20)
    pair_ok = slot_ok[:, :, None] & slot_ok[:, None, :]
    dmat = jnp.where(pair_ok, dmat, big)
    # median distance of each slot to the others (self-distance 0 included,
    # as in the reference's vDists row): sort row, take element at
    # (n_stored-1)//2
    dsort = jnp.sort(dmat, axis=-1)                     # [n, R, R]
    med_idx = (n_stored - 1) // 2
    med = jnp.take_along_axis(
        dsort, med_idx[:, None, None].repeat(DESC_RING, 1), axis=-1)[..., 0]
    med = jnp.where(slot_ok, med, big)                  # [n, R]
    best_slot = jnp.argmin(med, axis=-1)                # [n]
    rep = jnp.take_along_axis(
        cand, best_slot[:, None, None].repeat(8, -1), axis=1)[:, 0]
    desc = ms.mp_desc.at[mp_oob].set(rep)
    return ms._replace(kf_mp=kf_mp, mp_normal_sum=normal_sum, mp_n_obs=n_obs,
                       mp_desc=desc, mp_desc_ring=ring, mp_desc_n=desc_n,
                       mp_max_dist=max_dist, mp_min_dist=min_dist)


def compact_mask(mask: jax.Array, cap: int
                 ) -> Tuple[jax.Array, jax.Array]:
    """Indices of the first ``cap`` True entries of ``mask`` [M], in index
    order: (ids [cap], ok [cap]).  One cumsum + one scatter — replaces
    ``top_k(mask.astype(f32), cap)`` boolean compactions, which lower to a
    full O(M log M) sort at M = 16k-32k."""
    M = mask.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (rank < cap), rank, cap)
    ids = jnp.zeros((cap + 1,), jnp.int32).at[tgt].set(
        jnp.arange(M, dtype=jnp.int32))[:cap]
    ok = jnp.zeros((cap + 1,), bool).at[tgt].set(True)[:cap]
    return ids, ok


def alloc_mp_slots(ms: MapState, ok: jax.Array
                   ) -> Tuple[jax.Array, jax.Array]:
    """Allocate one free map-point row per ok=True entry, reusing culled
    rows (lowest index first).  Replaces the append-only watermark that
    silently exhausted capacity (VERDICT r2 weak #7): rows freed by
    MapPointCulling / Replace go back into circulation, so long sequences
    are bounded by *live* points, not points ever created.

    Returns (slots [n], ok' [n]) where ok' masks off requests that did not
    fit (map truly full)."""
    n = ok.shape[0]
    free_ids, has = compact_mask(~ms.mp_valid, n)
    rank = jnp.clip(jnp.cumsum(ok.astype(jnp.int32)) - 1, 0, n - 1)
    slots = free_ids[rank]
    ok = ok & has[rank]
    return slots.astype(jnp.int32), ok


def add_map_points(ms: MapState, slots: jax.Array, pos: jax.Array,
                   ok: jax.Array, ref_kf: jax.Array,
                   first_kf: jax.Array = None) -> MapState:
    """Batch-create map points in rows ``slots`` (MapPoint ctor,
    MapPoint.cc:32).  Observations/stats are added separately.

    ``first_kf``: creation ordinal (monotonic keyframe counter) used by
    MapPointCulling's age test — NOT the slot id, which is reused."""
    if first_kf is None:
        first_kf = ref_kf
    # masked rows go out of bounds — dropped by the scatter, no collisions
    s = jnp.where(ok, slots, ms.P)
    zero3 = jnp.zeros_like(pos)
    return ms._replace(
        mp_pos=ms.mp_pos.at[s].set(pos),
        mp_valid=ms.mp_valid.at[s].set(True),
        mp_normal_sum=ms.mp_normal_sum.at[s].set(zero3),
        mp_n_obs=ms.mp_n_obs.at[s].set(0),
        mp_desc_n=ms.mp_desc_n.at[s].set(0),
        mp_ref_kf=ms.mp_ref_kf.at[s].set(ref_kf),
        mp_first_kf=ms.mp_first_kf.at[s].set(first_kf),
        mp_visible=ms.mp_visible.at[s].set(1),
        mp_found=ms.mp_found.at[s].set(1),
    )


# ---------------------------------------------------------- covisibility ----

def obs_incidence(ms: MapState) -> jax.Array:
    """[K, P] bool: keyframe k observes map point p.

    NOTE: this materializes K·P entries (16M at production caps) — use it
    only for rare whole-graph work (essential graph, GBA).  Per-frame and
    per-insert paths must use the gather/scatter helpers below, which stay
    at [K, N] cost (VERDICT r2 weak #3)."""
    K, N, P = ms.K, ms.N, ms.P
    k_ids = jnp.repeat(jnp.arange(K, dtype=jnp.int32)[:, None], N, axis=1)
    mp = ms.kf_mp
    ok = (mp >= 0) & ms.kf_kp_valid & ms.kf_valid[:, None]
    mp_safe = jnp.where(ok, mp, 0)
    M = jnp.zeros((K, P), jnp.float32).at[k_ids, mp_safe].max(
        ok.astype(jnp.float32))
    return M > 0


def kf_obs_ok(ms: MapState) -> jax.Array:
    """[K, N] bool: feature n of keyframe k carries a live association."""
    return (ms.kf_mp >= 0) & ms.kf_kp_valid & ms.kf_valid[:, None]


def points_of_kf(ms: MapState, kf: jax.Array) -> jax.Array:
    """[P] bool mask of the map points observed by keyframe ``kf``
    (one scatter over that keyframe's N features)."""
    row = ms.kf_mp[kf]
    ok = (row >= 0) & ms.kf_kp_valid[kf]
    tgt = jnp.where(ok, row, ms.P)
    return jnp.zeros((ms.P,), bool).at[tgt].set(True)


def points_of_kfs(ms: MapState, kf_mask: jax.Array) -> jax.Array:
    """[P] bool mask of map points observed by any keyframe in ``kf_mask``
    — a [K·N] scatter instead of a [K, P] incidence reduction."""
    ok = kf_obs_ok(ms) & kf_mask[:, None]
    tgt = jnp.where(ok, ms.kf_mp, ms.P).reshape(-1)
    return jnp.zeros((ms.P,), bool).at[tgt].set(True)


def kf_share_counts(ms: MapState, mp_mask: jax.Array) -> jax.Array:
    """[K] int32: per keyframe, how many of its observed points fall in
    ``mp_mask`` — a [K, N] gather instead of a [K, P] matvec
    (KeyFrame::UpdateConnections weight semantics, KeyFrame.cc:284)."""
    ok = kf_obs_ok(ms)
    mp_safe = jnp.where(ok, ms.kf_mp, 0)
    hit = mp_mask[mp_safe] & ok
    return jnp.sum(hit.astype(jnp.int32), axis=1)


def covisibility_row(ms: MapState, kf: jax.Array) -> jax.Array:
    """[K] shared-point counts of one keyframe vs all others — one scatter
    + one [K, N] gather (no [K, P] incidence build)."""
    own = points_of_kf(ms, kf)
    w = kf_share_counts(ms, own)
    w = w.at[kf].set(0)
    return jnp.where(ms.kf_valid, w, 0)


def covisibility_rows(ms: MapState, kf_ids: jax.Array) -> jax.Array:
    """[C, K] shared-point counts for a small batch of keyframes — the
    bounded replacement for the full [K, K] graph in per-keyframe paths
    (VERDICT r3 weak #3).  Cost O(C·K·N): per-candidate point masks
    [C, P] by scatter, then one [C, K, N] gather — no [K, P] incidence,
    no [K, K] matmul."""
    C = kf_ids.shape[0]
    rows_mp = ms.kf_mp[kf_ids]                              # [C, N]
    rows_ok = (rows_mp >= 0) & ms.kf_kp_valid[kf_ids]
    tgt = jnp.where(rows_ok, rows_mp, ms.P)
    masks = jnp.zeros((C, ms.P + 1), bool).at[
        jnp.arange(C)[:, None], tgt].set(True)[:, :ms.P]    # [C, P]
    ok = kf_obs_ok(ms)                                      # [K, N]
    mp_safe = jnp.where(ok, ms.kf_mp, 0)
    hit = masks[:, mp_safe] & ok[None]                      # [C, K, N]
    w = jnp.sum(hit.astype(jnp.int32), axis=-1)             # [C, K]
    w = w.at[jnp.arange(C), kf_ids].set(0)
    return jnp.where(ms.kf_valid[None, :], w, 0)


def covisibility(ms: MapState) -> jax.Array:
    """[K, K] int32 shared-map-point counts — the covisibility graph
    (KeyFrame::UpdateConnections, KeyFrame.cc:284) as one matmul."""
    M = obs_incidence(ms).astype(jnp.float32)
    W = (M @ M.T).astype(jnp.int32)
    W = W - jnp.diag(jnp.diagonal(W))
    live = ms.kf_valid
    return jnp.where(live[:, None] & live[None, :], W, 0)


# ------------------------------------------------------------- map points ----

def mp_projection_query(ms: MapState) -> matching.ProjectionQuery:
    """All live map points as a ProjectionQuery (raw scale-invariance
    bounds; the matcher applies the reference's 0.8/1.2 frustum slack,
    MapPoint.cc:377-383)."""
    return matching.ProjectionQuery(
        pos_w=ms.mp_pos,
        normal=ms.mp_normal(),
        min_dist=ms.mp_min_dist,
        max_dist=ms.mp_max_dist,
        desc=ms.mp_desc,
        valid=ms.mp_valid,
    )


def remove_observations(ms: MapState, kf: jax.Array, feat_idx: jax.Array,
                        ok: jax.Array) -> MapState:
    """Erase feature→MP associations (outlier erasure after BA,
    Optimizer.cc:755-801).  Decrements n_obs (by 2 for stereo features,
    mirroring AddObservation); does not rebuild normals (the incremental
    sum keeps stale rays — refreshed on next BA pass)."""
    f_safe = jnp.where(ok, feat_idx, 0)
    mp = ms.kf_mp[kf, f_safe]
    really = ok & (mp >= 0)
    mp_oob = jnp.where(really, mp, ms.P)
    f_oob = jnp.where(really, feat_idx, ms.N)
    kf_mp = ms.kf_mp.at[kf, f_oob].set(NO_MP)
    dec = jnp.where(ms.kf_ur[kf, f_safe] >= 0, 2, 1)
    n_obs = ms.mp_n_obs.at[mp_oob].add(-dec)
    return ms._replace(kf_mp=kf_mp, mp_n_obs=n_obs)


def remove_observations_batch(ms: MapState, kfs: jax.Array,
                              ok2d: jax.Array) -> MapState:
    """Batched outlier erasure over many keyframes in ONE scatter pair —
    replaces the per-window-keyframe fori_loop after local BA.
    kfs: [M] keyframe ids; ok2d: [M, N] features to erase."""
    Mk, N = ok2d.shape
    f_idx = jnp.arange(N, dtype=jnp.int32)
    mp = ms.kf_mp[kfs]                            # [M, N]
    really = ok2d & (mp >= 0)
    mp_oob = jnp.where(really, mp, ms.P)
    f_oob = jnp.where(really, f_idx[None, :], ms.N)
    kf_rows = jnp.repeat(kfs[:, None], N, axis=1)
    kf_mp = ms.kf_mp.at[kf_rows, f_oob].set(NO_MP)
    dec = jnp.where(ms.kf_ur[kfs] >= 0, 2, 1)
    n_obs = ms.mp_n_obs.at[mp_oob].add(-dec)
    return ms._replace(kf_mp=kf_mp, mp_n_obs=n_obs)


def invalidate_map_points(ms: MapState, bad_mask: jax.Array) -> MapState:
    """MapPoint::SetBadFlag batched: kill points and all their observations
    (kf_mp rows referencing them are redirected to −1)."""
    mp_valid = ms.mp_valid & (~bad_mask)
    dead_ref = bad_mask[jnp.where(ms.kf_mp >= 0, ms.kf_mp, 0)] & (ms.kf_mp >= 0)
    kf_mp = jnp.where(dead_ref, NO_MP, ms.kf_mp)
    return ms._replace(mp_valid=mp_valid, kf_mp=kf_mp)


def replace_map_points(ms: MapState, old_to_new: jax.Array) -> MapState:
    """MapPoint::Replace batched (MapPoint.cc:177, loop fusion): redirect
    kf_mp references old→new and invalidate the old points.

    old_to_new: [P] int32, −1 for identity."""
    has_redir = old_to_new >= 0
    mp_ref = jnp.where(ms.kf_mp >= 0, ms.kf_mp, 0)
    redirected = jnp.where(
        (ms.kf_mp >= 0) & has_redir[mp_ref],
        old_to_new[mp_ref], ms.kf_mp)
    mp_valid = ms.mp_valid & (~has_redir)
    return ms._replace(kf_mp=redirected, mp_valid=mp_valid)
