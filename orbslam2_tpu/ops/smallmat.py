"""Exact small-matrix products as broadcast-multiply-reduce.

The geometry and normal-equation products in the optimizers contract
over tiny axes (2/3/4/6), where a matrix unit brings no throughput.
Spelling them as broadcast-multiply-reduce gives exact f32 arithmetic
independent of the matmul-precision flag (orbslam2_tpu/__init__.py),
and XLA fuses them with their neighbours.  Use these helpers for every
product whose contraction axis is O(10); leave genuinely large matmuls
(Hamming banks, one-hot sampling, the reduced-camera Cholesky) to
dot_general.  Matmul vs this form on the H100: not measured.

Role reference: g2o evaluates the same per-edge Jacobian/Hessian blocks
in scalar C++ doubles (Thirdparty/g2o types_six_dof_expmap.h:59-174);
exact f32 elementwise arithmetic is the array-shaped equivalent.
"""

from __future__ import annotations

import jax.numpy as jnp


def bmm(a, b):
    """[..., i, k] x [..., k, j] -> [..., i, j], exact f32 elementwise."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def matvec(m, v):
    """[..., i, k] x [..., k] -> [..., i]."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def vecmat(v, m):
    """[..., k] x [..., k, j] -> [..., j]  (= mᵀ v batched)."""
    return jnp.sum(v[..., :, None] * m, axis=-2)


def outer_acc(a, b):
    """[..., r, i] x [..., r, j] -> [..., i, j], summed over r.

    The JᵀW J block build: a = weighted Jacobian rows, b = Jacobian rows.
    """
    return jnp.sum(a[..., :, :, None] * b[..., :, None, :], axis=-3)


def tmatvec(a, e):
    """[..., r, i] x [..., r] -> [..., i]  (= aᵀ e batched): Jᵀe."""
    return jnp.sum(a * e[..., None], axis=-2)
