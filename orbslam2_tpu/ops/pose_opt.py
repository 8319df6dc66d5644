"""Motion-only pose optimization: JAX Levenberg-Marquardt on one SE3 vertex.

Replaces ``Optimizer::PoseOptimization`` (src/Optimizer.cc:283-495): a g2o
LM solve over a single SE3 pose with unary mono/stereo reprojection edges,
run as 4 rounds × 10 iterations with chi²-based inlier reclassification
between rounds and the Huber kernel dropped after round 2.

Batched shape: residuals/Jacobians for all N observations evaluated
batched, reduced to a 6×6 normal system (one matmul), solved in-register.
Fixed iteration counts, no data-dependent control flow — the whole solve is
one jittable function.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.config import OptimizerConfig
from orbslam2_tpu.ops import smallmat as sm
from orbslam2_tpu.utils import camera as cam_mod
from orbslam2_tpu.utils import lie

CHI2_MONO = 5.991    # chi² 95% 2-dof (Optimizer.cc:419)
CHI2_STEREO = 7.815  # chi² 95% 3-dof (Optimizer.cc:447)


class PoseObs(NamedTuple):
    """Unary reprojection edges for one frame."""

    pts_w: jax.Array      # [N, 3] world landmark positions (fixed)
    uv: jax.Array         # [N, 2] undistorted measurements
    ur: jax.Array         # [N] right coord (<0 ⇒ monocular edge)
    inv_sigma2: jax.Array  # [N] information weight (1/level sigma²)
    valid: jax.Array      # [N] bool


def _residuals_jac(cam: cam_mod.Camera, Tcw: jax.Array, obs: PoseObs):
    """Batched residuals [N,3] and Jacobians [N,3,6] (tangent [ω,υ], left
    convention T ← exp(ξ)·T).  Third row is the stereo u_r edge, zeroed for
    monocular observations."""
    R, t = lie.mat_to_rt(Tcw)
    # Broadcast form of pts @ Rᵀ (exact f32, precision-flag-free —
    # ops/smallmat.py); this evaluation sits inside the 40-iteration LM
    # scan and runs up to 3× per tracked frame
    pc = jnp.sum(obs.pts_w[:, None, :] * R[None, :, :], axis=-1) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_safe = jnp.where(z < 1e-6, 1e-6, z)
    invz = 1.0 / z_safe
    invz2 = invz * invz

    u = cam.fx * x * invz + cam.cx
    v = cam.fy * y * invz + cam.cy
    ur_pred = u - cam.bf * invz
    is_stereo = obs.ur >= 0

    e = jnp.stack([obs.uv[:, 0] - u,
                   obs.uv[:, 1] - v,
                   jnp.where(is_stereo, obs.ur - ur_pred, 0.0)], axis=-1)

    # d proj / d pc
    zero = jnp.zeros_like(x)
    du_dp = jnp.stack([cam.fx * invz, zero, -cam.fx * x * invz2], axis=-1)
    dv_dp = jnp.stack([zero, cam.fy * invz, -cam.fy * y * invz2], axis=-1)
    dur_dp = du_dp + jnp.stack([zero, zero, cam.bf * invz2], axis=-1)
    dproj = jnp.stack([du_dp, dv_dp,
                       jnp.where(is_stereo[:, None], dur_dp, 0.0)], axis=-2)

    # d pc / d ξ = [ -[pc]× | I ]
    dpc = jnp.concatenate([-lie.hat(pc), jnp.broadcast_to(
        jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))], axis=-1)
    J = -sm.bmm(dproj, dpc)                              # [N, 3, 6]
    behind = z < 1e-6
    return e, J, is_stereo, behind


def _chi2(e: jax.Array, is_stereo: jax.Array, inv_sigma2: jax.Array):
    sq = jnp.sum(e * e, axis=-1) * inv_sigma2
    return sq, jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)


def pose_optimization(
    cam: cam_mod.Camera,
    Tcw0: jax.Array,
    obs: PoseObs,
    opt_cfg: OptimizerConfig = OptimizerConfig(),
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (Tcw, inlier_mask [N], n_inliers).

    Mirrors Optimizer.cc:411-486: each round re-optimizes from the current
    estimate over current inliers, then reclassifies every observation by
    chi²; rounds 0-1 use the Huber robust kernel, rounds 2-3 plain L2.
    """
    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)

    def _normal_eq(Tcw, inlier, use_huber):
        """One residual/Jacobian evaluation → (H, b, total objective).

        The accept test must use the SAME objective the step minimizes:
        with the Huber kernel active that is the robustified chi²
        ρ(χ²) = 2δ√χ² − δ² beyond δ (g2o's activeRobustChi2), NOT the raw
        chi² — comparing raw totals lets a single gross outlier veto every
        good step and freezes the solve."""
        e, J, is_stereo, behind = _residuals_jac(cam, Tcw, obs)
        w = obs.inv_sigma2 * inlier.astype(jnp.float32) \
            * (~behind).astype(jnp.float32)
        chi2, _ = _chi2(e, is_stereo, obs.inv_sigma2)
        rho = chi2
        if use_huber:
            delta = jnp.where(is_stereo, delta_stereo, delta_mono)
            sq = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            w = w * jnp.where(sq > delta, delta / sq, 1.0)
            rho = jnp.where(sq > delta, 2.0 * delta * sq - delta * delta,
                            chi2)
        Jw = J * w[:, None, None]
        H = jnp.einsum("nij,nik->jk", Jw, J)
        b = jnp.einsum("nij,ni->j", Jw, e)
        total = jnp.sum(jnp.where(inlier & (~behind), rho, 0.0))
        return H, b, total

    def lm_round(Tcw, inlier, use_huber):
        # True LM with rollback at ONE residual/Jacobian evaluation per
        # iteration: carry the normal equations of the best-so-far pose.
        # Trying a step needs only (H_best, b_best); evaluating the
        # candidate produces its own (H, b, chi²) which become the carried
        # state iff accepted.  (The naive form evaluates twice per
        # iteration along an 80-iteration dependency chain.)
        def iteration(carry, _):
            T_best, H_best, b_best, chi2_best, lam, done = carry

            def work(_):
                H_lm = H_best + lam * jnp.eye(6, dtype=H_best.dtype)
                dx = -jnp.linalg.solve(H_lm, b_best)
                T_cand = lie.se3_exp(dx) @ T_best
                H_c, b_c, chi2_c = _normal_eq(T_cand, inlier, use_huber)
                accept = chi2_c < chi2_best
                gain = (chi2_best - chi2_c) / jnp.maximum(chi2_best, 1e-9)
                # g2o-style termination: converged (tiny relative gain on
                # an accepted step) or stuck (λ blown up) — remaining scan
                # iterations take the no-op branch, so fixed trip counts
                # stop costing fixed device time
                done2 = (accept & (gain < 1e-5)) | (lam > 1e7)
                return (jnp.where(accept, T_cand, T_best),
                        jnp.where(accept, H_c, H_best),
                        jnp.where(accept, b_c, b_best),
                        jnp.where(accept, chi2_c, chi2_best),
                        jnp.where(accept, lam * 0.5, lam * 4.0),
                        done2)

            carry = jax.lax.cond(done, lambda _: carry, work, None)
            return carry, None

        H0, b0, chi2_0 = _normal_eq(Tcw, inlier, use_huber)
        lam0 = jnp.asarray(opt_cfg.initial_lambda, Tcw.dtype)
        (Tcw, _, _, _, _, _), _ = jax.lax.scan(
            iteration, (Tcw, H0, b0, chi2_0, lam0, jnp.bool_(False)), None,
            length=iters_per_round)
        return Tcw

    Tcw = Tcw0
    inlier = obs.valid
    for rnd in range(n_rounds):
        Tcw = lm_round(Tcw, inlier, use_huber=(rnd < 2))
        e, _, is_stereo, behind = _residuals_jac(cam, Tcw, obs)
        chi2, th = _chi2(e, is_stereo, obs.inv_sigma2)
        inlier = obs.valid & (chi2 <= th) & (~behind)
    return Tcw, inlier, jnp.sum(inlier.astype(jnp.int32))
