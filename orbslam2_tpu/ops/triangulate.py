"""Two-view triangulation + new-map-point creation between keyframes.

Replaces ``LocalMapping::CreateNewMapPoints`` (src/LocalMapping.cc:207):
epipolar-constrained matching of unassociated features against covisible
keyframes, SVD linear triangulation (:322-337), and the parallax /
cheirality / reprojection / scale-consistency acceptance checks
(:299-431) — all batched over the full feature set.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_tpu.config import SlamConfig
from orbslam2_tpu.models import map_state as M
from orbslam2_tpu.ops import matching
from orbslam2_tpu.ops import smallmat as sm
from orbslam2_tpu.utils import camera as cam_mod
from orbslam2_tpu.utils import lie


def triangulate_dlt(P1: jax.Array, P2: jax.Array, uv1: jax.Array,
                    uv2: jax.Array) -> jax.Array:
    """Linear triangulation (Initializer::Triangulate, Initializer.cc:733).

    P1/P2: [3, 4] projection matrices (K[R|t]); uv1/uv2: [N, 2].
    Returns [N, 3] world points.

    Inhomogeneous DLT (w=1): the 4×4 smallest-singular-vector problem
    becomes a closed-form 3×3 normal-equation solve — elementwise math
    instead of a batched iterative eig/SVD.
    Points at infinity (where w=1 degenerates) are rejected downstream by
    the parallax gate (cos_par < 0.9998) in every caller.
    """
    from orbslam2_tpu.ops.bundle import _inv3x3

    rows = [
        uv1[:, 0:1] * P1[2] - P1[0],
        uv1[:, 1:2] * P1[2] - P1[1],
        uv2[:, 0:1] * P2[2] - P2[0],
        uv2[:, 1:2] * P2[2] - P2[1],
    ]
    A = jnp.stack(rows, axis=1)                      # [N, 4, 4]
    B = A[:, :, :3]
    b = -A[:, :, 3]
    BtB = sm.outer_acc(B, B)
    Btb = sm.tmatvec(B, b)
    return sm.matvec(_inv3x3(BtB), Btb)


class TriangulationResult(NamedTuple):
    pos_w: jax.Array     # [N, 3] candidate new points
    ok: jax.Array        # [N] acceptance
    match2: jax.Array    # [N] matched feature in KF2 (−1)


def make_triangulation_bodies(cfg: SlamConfig):
    """Un-jitted (triangulate_between, insert_triangulated) bodies for
    fusion into larger programs (runtime/local_mapping.make_mapping_step)."""
    cam = cam_mod.Camera.from_config(cfg.camera)
    sigma2 = np.array(   # numpy: captured as a jit closure constant
        [cfg.orb.scale_factor ** (2 * l) for l in range(cfg.orb.n_levels)],
        np.float32)
    sf = cfg.orb.scale_factor
    ratio_factor = 1.5 * sf

    def triangulate_between(ms: M.MapState, kf1: jax.Array, kf2: jax.Array
                            ) -> TriangulationResult:
        """Candidate points between keyframes kf1/kf2 from features not yet
        associated to any map point.

        The kf1 side is compacted to its free features before the [·, N]
        epipolar/Hamming matrices — after tracking, well under half of a
        keyframe's features are unassociated, and this kernel runs
        ``triangulation_neighbors`` times per insertion."""
        N = ms.N
        R1 = max(256, N // 2)                   # compacted kf1 rows
        T1, T2 = ms.kf_pose[kf1], ms.kf_pose[kf2]
        free1_full = ms.kf_kp_valid[kf1] & (ms.kf_mp[kf1] < 0)
        free2 = ms.kf_kp_valid[kf2] & (ms.kf_mp[kf2] < 0)
        rows, free1 = M.compact_mask(free1_full, R1)
        m_c, _ = matching.search_for_triangulation(
            cam, T1, T2,
            ms.kf_xy[kf1][rows], ms.kf_level[kf1][rows],
            ms.kf_desc[kf1][rows], free1,
            ms.kf_xy[kf2], ms.kf_level[kf2], ms.kf_desc[kf2], free2,
            ms.kf_angle[kf1][rows], ms.kf_angle[kf2], sigma2)
        # scatter the compacted matches back to full [N] alignment
        m = jnp.full((N + 1,), -1, jnp.int32).at[
            jnp.where(free1, rows, N)].set(m_c)[:N]
        ok = m >= 0
        msafe = jnp.where(ok, m, 0)
        uv1 = ms.kf_xy[kf1]
        uv2 = ms.kf_xy[kf2][msafe]

        K_mat = cam.K
        P1 = K_mat @ T1[:3, :]
        P2 = K_mat @ T2[:3, :]
        Xw = triangulate_dlt(P1, P2, uv1, uv2)

        # rays + parallax (LocalMapping.cc:250-320)
        C1 = -T1[:3, :3].T @ T1[:3, 3]
        C2 = -T2[:3, :3].T @ T2[:3, 3]
        r1 = Xw - C1
        r2 = Xw - C2
        d1 = jnp.linalg.norm(r1, axis=-1)
        d2 = jnp.linalg.norm(r2, axis=-1)
        cos_par = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(d1 * d2, 1e-9)

        # cheirality + reprojection chi² in both views (:341-407)
        pc1 = lie.transform_points(T1, Xw[None])[0]
        pc2 = lie.transform_points(T2, Xw[None])[0]
        p1 = cam_mod.project(cam, pc1)
        p2 = cam_mod.project(cam, pc2)
        sigma2_j = jnp.asarray(sigma2)
        e1 = jnp.sum((p1 - uv1) ** 2, axis=-1) / sigma2_j[ms.kf_level[kf1]]
        e2 = jnp.sum((p2 - uv2) ** 2, axis=-1) \
            / sigma2_j[ms.kf_level[kf2][msafe]]

        # scale consistency (:409-421)
        ratio_dist = d2 / jnp.maximum(d1, 1e-9)
        ratio_octave = (jnp.power(sf, ms.kf_level[kf1]).astype(jnp.float32)
                        / jnp.power(sf, ms.kf_level[kf2][msafe]))
        scale_ok = (ratio_dist * ratio_factor > ratio_octave) & \
                   (ratio_dist < ratio_octave * ratio_factor)

        ok = (ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0)
              & (cos_par < 0.9998)
              & (e1 < 5.991) & (e2 < 5.991) & scale_ok
              & (d1 > 1e-3) & (d2 > 1e-3))
        return TriangulationResult(pos_w=Xw, ok=ok, match2=m)

    def insert_triangulated(ms: M.MapState, kf1: jax.Array, kf2: jax.Array,
                            tri: TriangulationResult, kf_ordinal: jax.Array
                            ) -> Tuple[M.MapState, jax.Array]:
        """Allocate slots for accepted candidates (reusing culled rows) and
        add observations in both keyframes."""
        N = ms.N
        slots, ok = M.alloc_mp_slots(ms, tri.ok)
        ms = M.add_map_points(ms, slots, tri.pos_w, ok,
                              ref_kf=jnp.full((N,), kf1, jnp.int32),
                              first_kf=jnp.full((N,), kf_ordinal, jnp.int32))
        feat_idx = jnp.arange(N, dtype=jnp.int32)
        ms = M.add_observations(ms, kf1, feat_idx,
                                jnp.where(ok, slots, M.NO_MP), ok,
                                sf, cfg.orb.n_levels)
        m2 = jnp.where(ok, tri.match2, 0)
        ms = M.add_observations(ms, kf2, m2, jnp.where(ok, slots, M.NO_MP),
                                ok, sf, cfg.orb.n_levels)
        return ms, jnp.sum(ok.astype(jnp.int32))

    return triangulate_between, insert_triangulated


def make_triangulation_fn(cfg: SlamConfig):
    """Jitted (triangulate_between, insert_triangulated) pair."""
    tri, ins = make_triangulation_bodies(cfg)
    return jax.jit(tri), jax.jit(ins)
