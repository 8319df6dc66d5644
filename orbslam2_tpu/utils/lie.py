"""SO(3) / SE(3) / Sim(3) Lie-group operations, batched and jit-friendly.

Replaces the reference's ``Converter`` (src/Converter.cc:26-126, cv::Mat ⇄
Eigen ⇄ g2o::SE3Quat/Sim3) and the manifold machinery inside g2o
(``Thirdparty/g2o/g2o/types/types_six_dof_expmap.h``,
``types_seven_dof_expmap.h``).  Everything here operates on arrays with
arbitrary leading batch dimensions — poses are ``[..., 4, 4]`` homogeneous
matrices, tangents are ``[..., 6]`` (SE3: [ω, υ]) or ``[..., 7]``
(Sim3: [ω, υ, σ]) — so RANSAC hypotheses and BA blocks vectorize onto the
device instead of looping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def _safe_norm(v: "jax.Array") -> "jax.Array":
    """Gradient-safe vector norm: d/dv at v=0 is 0, not NaN.  Lie maps are
    linearized at the identity (x=0) by the pose-graph/BA solvers, so every
    θ=‖ω‖ here must differentiate cleanly through zero."""
    return jnp.sqrt(jnp.sum(v * v, axis=-1) + 1e-24)


# ----------------------------------------------------------------- SO(3) ----

def hat(w: jax.Array) -> jax.Array:
    """[..., 3] → [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def vee(W: jax.Array) -> jax.Array:
    """[..., 3, 3] skew → [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc(x: jax.Array) -> jax.Array:
    """sin(x)/x with the x→0 limit handled smoothly."""
    small = jnp.abs(x) < 1e-4
    xs = jnp.where(small, jnp.ones_like(x), x)
    return jnp.where(small, 1.0 - x * x / 6.0, jnp.sin(xs) / xs)


def _cosc(x: jax.Array) -> jax.Array:
    """(1 - cos(x)) / x² with the x→0 limit handled smoothly."""
    small = jnp.abs(x) < 1e-4
    xs = jnp.where(small, jnp.ones_like(x), x)
    return jnp.where(small, 0.5 - x * x / 24.0, (1.0 - jnp.cos(xs)) / (xs * xs))


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: [..., 3] axis-angle → [..., 3, 3] rotation."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jax.Array) -> jax.Array:
    """[..., 3, 3] rotation → [..., 3] axis-angle.  Valid for θ < π − ε.

    atan2 formulation: gradient-safe at θ=0 (arccos'(±1) is infinite and
    would leak NaN through the unselected where-branch during autodiff)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(θ) * axis
    sin_t = _safe_norm(w)
    theta = jnp.arctan2(sin_t, cos_t)
    general = w * (theta / jnp.where(sin_t < _EPS, 1.0, sin_t))[..., None]
    small = w  # θ→0: log ≈ vee of the antisymmetric part
    # θ≈π branch: R ≈ I + 2 aaᵀ − ... ; axis from diagonal of (R+I)/2
    B = (R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)) * 0.5
    axis_sq = jnp.clip(jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1), 1e-24, None)
    axis = jnp.sqrt(axis_sq)
    # fix signs from off-diagonals (largest-component convention)
    sx = jnp.sign(jnp.where(w[..., 0] == 0, 1.0, w[..., 0]))
    signs = jnp.stack([
        jnp.ones_like(axis[..., 0]),
        jnp.sign(jnp.where(B[..., 0, 1] == 0, 1.0, B[..., 0, 1])),
        jnp.sign(jnp.where(B[..., 0, 2] == 0, 1.0, B[..., 0, 2])),
    ], axis=-1)
    near_pi_axis = axis * signs * sx[..., None]
    near_pi = near_pi_axis / _safe_norm(near_pi_axis)[..., None] \
        * theta[..., None]
    out = jnp.where((theta < 1e-5)[..., None], small,
                    jnp.where((sin_t < 1e-4)[..., None], near_pi, general))
    return out


def so3_left_jacobian(w: jax.Array) -> jax.Array:
    """V such that exp([ω]×) translation part = V υ.  [..., 3] → [..., 3, 3]."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    t = theta
    small = t < 1e-4
    ts = jnp.where(small, jnp.ones_like(t), t)
    A = jnp.where(small, 0.5 - t * t / 24.0, (1.0 - jnp.cos(ts)) / (ts * ts))
    B = jnp.where(small, 1.0 / 6.0 - t * t / 120.0, (ts - jnp.sin(ts)) / (ts ** 3))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_left_jacobian_inv(w: jax.Array) -> jax.Array:
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    t = theta
    small = t < 1e-4
    ts = jnp.where(small, jnp.ones_like(t), t)
    half = ts * 0.5
    cot = half / jnp.tan(half)
    K = jnp.where(small, 1.0 / 12.0 + t * t / 720.0, (1.0 - cot) / (ts * ts))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + K[..., None, None] * W2


# ----------------------------------------------------------------- SE(3) ----

def se3_exp(xi: jax.Array) -> jax.Array:
    """[..., 6] twist [ω, υ] → [..., 4, 4] transform (g2o SE3Quat::exp order)."""
    w, v = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """[..., 4, 4] → [..., 6] twist [ω, υ]."""
    R, t = mat_to_rt(T)
    w = so3_log(R)
    Vinv = so3_left_jacobian_inv(w)
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def rt_to_mat(R: jax.Array, t: jax.Array) -> jax.Array:
    """([..., 3, 3], [..., 3]) → [..., 4, 4]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.broadcast_to(jnp.eye(4, dtype=R.dtype), batch + (4, 4))
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    return T


def mat_to_rt(T: jax.Array):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inv(T: jax.Array) -> jax.Array:
    R, t = mat_to_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """[..., 4, 4] × [..., N, 3] → [..., N, 3].

    Broadcast-multiply-reduce, not ``pts @ Rᵀ``: a 3-wide contraction
    gains nothing from a matmul, and this form is exact f32 and
    independent of the matmul-precision flag (ops/smallmat.py)."""
    R, t = mat_to_rt(T)
    pts = jnp.asarray(pts)
    if pts.ndim == R.ndim - 1:          # single point per pose: [..., 3]
        return jnp.sum(pts[..., None, :] * R, axis=-1) + t
    return (jnp.sum(pts[..., :, None, :] * R[..., None, :, :], axis=-1)
            + t[..., None, :])


# ------------------------------------------------------------- quaternion ----

def quat_from_mat(R: jax.Array) -> jax.Array:
    """[..., 3, 3] → [..., 4] quaternion (x, y, z, w), TUM trajectory order
    (System.cc:516 writes q.x q.y q.z q.w)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate extractions; pick numerically safest (largest pivot)
    qw0 = jnp.sqrt(jnp.clip(1.0 + tr, _EPS, None)) * 0.5
    q0 = jnp.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                    (m10 - m01) / (4 * qw0), qw0], axis=-1)
    qx1 = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, _EPS, None)) * 0.5
    q1 = jnp.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                    (m21 - m12) / (4 * qx1)], axis=-1)
    qy2 = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, _EPS, None)) * 0.5
    q2 = jnp.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                    (m02 - m20) / (4 * qy2)], axis=-1)
    qz3 = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, _EPS, None)) * 0.5
    q3 = jnp.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                    (m10 - m01) / (4 * qz3)], axis=-1)
    cond_tr = (tr > 0.0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = jnp.where(cond_tr, q0, jnp.where(cond_x, q1, jnp.where(cond_y, q2, q3)))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def mat_from_quat(q: jax.Array) -> jax.Array:
    """[..., 4] (x, y, z, w) → [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack([
        jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ], axis=-2)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


def euler_from_quat(q: jax.Array) -> jax.Array:
    """[..., 4] (x,y,z,w) → [..., 3] roll/pitch/yaw — HPose.cpp semantics."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = jnp.arcsin(jnp.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)


# ----------------------------------------------------------------- Sim(3) ----
# Represented as (s, R, t): x ↦ s·R·x + t — matching g2o::Sim3
# (Thirdparty/g2o/g2o/types/sim3/sim3.h semantics, rebuilt batched).

def sim3_apply(s: jax.Array, R: jax.Array, t: jax.Array, pts: jax.Array) -> jax.Array:
    """([...], [...,3,3], [...,3]) on [..., N, 3]."""
    return s[..., None, None] * (pts @ jnp.swapaxes(R, -1, -2)) + t[..., None, :]


def sim3_inv(s: jax.Array, R: jax.Array, t: jax.Array):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -(s_inv[..., None] * (Rt @ t[..., None])[..., 0])


def sim3_mul(s1, R1, t1, s2, R2, t2):
    """(s1,R1,t1) ∘ (s2,R2,t2): first apply 2, then 1."""
    return s1 * s2, R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1


def sim3_exp(xi: jax.Array):
    """[..., 7] = [ω, υ, σ] → (s, R, t).  W-matrix closed form."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(w)
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    # W-coefficients (Strasdat Sim3 exp): t = W_mat · υ
    #   W_mat = A·I + B·W + C·W²  with σ, θ limits handled
    eps = 1e-5
    sig_small = jnp.abs(sigma) < eps
    th_small = theta < eps
    sig_s = jnp.where(sig_small, jnp.ones_like(sigma), sigma)
    th_s = jnp.where(th_small, jnp.ones_like(theta), theta)
    # A = (s - 1)/σ
    A = jnp.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                  (s - 1.0) / sig_s)
    denom = sig_s * sig_s + th_s * th_s
    sin_t, cos_t = jnp.sin(th_s), jnp.cos(th_s)
    # general both-nonzero case
    B_gen = (sig_s * (s * sin_t) + th_s * (1.0 - s * cos_t)) / (th_s * denom)
    C_gen = (A - ((s * cos_t - 1.0) * sig_s + s * sin_t * th_s) / denom) / (th_s * th_s)
    # σ→0 case: standard SE3 left Jacobian coefficients
    B_sig0 = _cosc(theta)
    C_sig0 = jnp.where(th_small, 1.0 / 6.0, (th_s - jnp.sin(th_s)) / (th_s ** 3))
    # θ→0 case
    B_th0 = jnp.where(sig_small, 0.5 + sigma / 6.0,
                      ((sig_s - 1.0) * s + 1.0) / (sig_s * sig_s))
    C_th0 = jnp.where(
        sig_small, 1.0 / 6.0 + sigma / 24.0,
        (s * (0.5 * sig_s * sig_s - sig_s + 1.0) - 1.0) / (sig_s ** 3))
    B = jnp.where(th_small, B_th0, jnp.where(sig_small, B_sig0, B_gen))
    C = jnp.where(th_small, C_th0, jnp.where(sig_small, C_sig0, C_gen))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    Wmat = A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2
    t = (Wmat @ v[..., None])[..., 0]
    return s, R, t


def sim3_log(s: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """(s, R, t) → [..., 7].  Inverts sim3_exp by solving W_mat·υ = t."""
    sigma = jnp.log(s)
    w = so3_log(R)
    xi_wv0 = jnp.concatenate([w, jnp.zeros_like(w), sigma[..., None]], axis=-1)
    Wmat = _sim3_wmat(xi_wv0)
    v = jnp.linalg.solve(Wmat, t[..., None])[..., 0]
    return jnp.concatenate([w, v, sigma[..., None]], axis=-1)


def _sim3_wmat(xi: jax.Array) -> jax.Array:
    """The W matrix of sim3_exp as a standalone (for log)."""
    w, sigma = xi[..., :3], xi[..., 6]
    s = jnp.exp(sigma)
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    eps = 1e-5
    sig_small = jnp.abs(sigma) < eps
    th_small = theta < eps
    sig_s = jnp.where(sig_small, jnp.ones_like(sigma), sigma)
    th_s = jnp.where(th_small, jnp.ones_like(theta), theta)
    A = jnp.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                  (s - 1.0) / sig_s)
    denom = sig_s * sig_s + th_s * th_s
    sin_t, cos_t = jnp.sin(th_s), jnp.cos(th_s)
    B_gen = (sig_s * (s * sin_t) + th_s * (1.0 - s * cos_t)) / (th_s * denom)
    C_gen = (A - ((s * cos_t - 1.0) * sig_s + s * sin_t * th_s) / denom) / (th_s * th_s)
    B_sig0 = _cosc(theta)
    C_sig0 = jnp.where(th_small, 1.0 / 6.0, (th_s - jnp.sin(th_s)) / (th_s ** 3))
    B_th0 = jnp.where(sig_small, 0.5 + sigma / 6.0,
                      ((sig_s - 1.0) * s + 1.0) / (sig_s * sig_s))
    C_th0 = jnp.where(
        sig_small, 1.0 / 6.0 + sigma / 24.0,
        (s * (0.5 * sig_s * sig_s - sig_s + 1.0) - 1.0) / (sig_s ** 3))
    B = jnp.where(th_small, B_th0, jnp.where(sig_small, B_sig0, B_gen))
    C = jnp.where(th_small, C_th0, jnp.where(sig_small, C_sig0, C_gen))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2


def sim3_to_mat(s: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """(s,R,t) → [..., 4, 4] with sR in the upper block."""
    return rt_to_mat(s[..., None, None] * R, t)


def mat_to_sim3(T: jax.Array):
    sR = T[..., :3, :3]
    s = jnp.exp(jnp.log(jnp.clip(jnp.linalg.det(sR), 1e-30, None)) / 3.0)
    return s, sR / s[..., None, None], T[..., :3, 3]
