"""Sim(3) pose-graph optimization — the essential graph after loop closure.

Replaces ``Optimizer::OptimizeEssentialGraph`` (src/Optimizer.cc:825):
g2o's BlockSolver_7_3 over Sim3 vertices with loop / spanning-tree /
covisibility(≥100) / previous-loop edges, 20 iterations, then SE3 recovery
with scale division (:1035-1054) and map-point correction through each
point's reference keyframe (:1057-1087).

Dense formulation: vertices are tangent perturbations x ∈ R^{K×7}
around base Sim3s; the residual over all E edges evaluates batched, and
the Gauss-Newton normal equations are solved **matrix-free** — JᵀJ·v is
one jvp + one vjp through the residual function, so conjugate gradients
never materializes a sparse Hessian (the g2o sparse-Cholesky role).  Fixed
vertices and the stereo fix-scale constraint are projections inside the CG
operator.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.utils import lie


class PoseGraphProblem(NamedTuple):
    # vertices: world→kf Sim3 as (s, R, t)
    s: jax.Array          # [K]
    R: jax.Array          # [K, 3, 3]
    t: jax.Array          # [K, 3]
    fixed: jax.Array      # [K] bool — loop KF anchor (Optimizer.cc:886)
    vertex_valid: jax.Array  # [K]
    # edges with relative measurement S_ij ≈ S_i ∘ S_j⁻¹
    e_i: jax.Array        # [E] int32
    e_j: jax.Array        # [E] int32
    m_s: jax.Array        # [E]
    m_R: jax.Array        # [E, 3, 3]
    m_t: jax.Array        # [E, 3]
    e_weight: jax.Array   # [E] float32 (0 = padding)


def _vertex_poses(prob: PoseGraphProblem, x: jax.Array):
    """Apply tangent x [K, 7]: S_i = exp(x_i) ∘ base_i."""
    ds, dR, dt = lie.sim3_exp(x)
    return lie.sim3_mul(ds, dR, dt, prob.s, prob.R, prob.t)


def _residuals(prob: PoseGraphProblem, x: jax.Array) -> jax.Array:
    """[E, 7] edge residuals log(meas⁻¹ ∘ S_i ∘ S_j⁻¹), weighted."""
    s, R, t = _vertex_poses(prob, x)
    si, Ri, ti = s[prob.e_i], R[prob.e_i], t[prob.e_i]
    sj, Rj, tj = s[prob.e_j], R[prob.e_j], t[prob.e_j]
    sji, Rji, tji = lie.sim3_inv(sj, Rj, tj)
    rs, rR, rt = lie.sim3_mul(si, Ri, ti, sji, Rji, tji)
    ms, mR, mt = lie.sim3_inv(prob.m_s, prob.m_R, prob.m_t)
    es, eR, et = lie.sim3_mul(ms, mR, mt, rs, rR, rt)
    r = lie.sim3_log(es, eR, et)
    return r * jnp.sqrt(jnp.maximum(prob.e_weight, 0.0))[:, None]


@functools.partial(jax.jit, static_argnames=("n_iters", "cg_iters",
                                             "fix_scale"))
def optimize_pose_graph(
    prob: PoseGraphProblem,
    n_iters: int = 20,
    cg_iters: int = 64,
    fix_scale: bool = True,
    damping: float = 1e-6,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Returns optimized (s, R, t) per vertex."""
    K = prob.s.shape[0]

    # tangent mask: fixed/invalid vertices frozen; stereo freezes σ
    mask = (prob.vertex_valid & (~prob.fixed)).astype(jnp.float32)[:, None]
    mask = jnp.tile(mask, (1, 7))
    if fix_scale:
        mask = mask.at[:, 6].set(0.0)

    def gn_step(carry, _):
        s, R, t = carry
        base = PoseGraphProblem(s=s, R=R, t=t, fixed=prob.fixed,
                                vertex_valid=prob.vertex_valid,
                                e_i=prob.e_i, e_j=prob.e_j, m_s=prob.m_s,
                                m_R=prob.m_R, m_t=prob.m_t,
                                e_weight=prob.e_weight)
        x0 = jnp.zeros((K, 7), s.dtype)
        r0, jvp_fn = jax.linearize(lambda x: _residuals(base, x), x0)
        _, vjp_fn = jax.vjp(lambda x: _residuals(base, x), x0)

        def A(v):  # (JᵀJ + λI) v with the freeze mask projected in and out
            v = v * mask
            jv = jvp_fn(v)
            out = vjp_fn(jv)[0]
            return out * mask + damping * v

        b = -(vjp_fn(r0)[0]) * mask
        # plain CG on the normal equations
        def cg_body(carry, _):
            xk, rk, pk, rs_old = carry
            Ap = A(pk)
            alpha = rs_old / jnp.maximum(jnp.vdot(pk, Ap), 1e-20)
            xk = xk + alpha * pk
            rk = rk - alpha * Ap
            rs_new = jnp.vdot(rk, rk)
            pk = rk + (rs_new / jnp.maximum(rs_old, 1e-20)) * pk
            return (xk, rk, pk, rs_new), None

        x0v = jnp.zeros_like(b)
        (dx, _, _, _), _ = jax.lax.scan(
            cg_body, (x0v, b, b, jnp.vdot(b, b)), None, length=cg_iters)
        dx = dx * mask
        ds, dR, dt = lie.sim3_exp(dx)
        s2, R2, t2 = lie.sim3_mul(ds, dR, dt, s, R, t)
        return (s2, R2, t2), None

    (s, R, t), _ = jax.lax.scan(gn_step, (prob.s, prob.R, prob.t), None,
                                length=n_iters)
    return s, R, t


def sim3_from_se3(T: jax.Array):
    """[..., 4, 4] SE3 → (s=1, R, t)."""
    R, t = lie.mat_to_rt(T)
    return jnp.ones(T.shape[:-2], T.dtype), R, t


def se3_from_sim3(s: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """Sim3 → SE3 with translation divided by scale (Optimizer.cc:1046)."""
    return lie.rt_to_mat(R, t / s[..., None])


def correct_points(mp_pos: jax.Array, ref_old_s, ref_old_R, ref_old_t,
                   ref_new_s, ref_new_R, ref_new_t) -> jax.Array:
    """Map-point correction through the reference KF (Optimizer.cc:1057):
    p' = S_new⁻¹(S_old(p)), all arrays batched per point [P, ...]."""
    pc = lie.sim3_apply(ref_old_s, ref_old_R, ref_old_t, mp_pos[..., None, :])
    inv = lie.sim3_inv(ref_new_s, ref_new_R, ref_new_t)
    out = lie.sim3_apply(inv[0], inv[1], inv[2], pc)
    return out[..., 0, :]
