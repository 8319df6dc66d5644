"""Batched 256-bit Hamming distance — the system's hottest scalar kernel
made dense.

Replaces ``ORBmatcher::DescriptorDistance`` (src/ORBmatcher.cc:1643, the
bit-twiddling popcount called in every matcher inner loop) and fbow's SIMD
``Lx`` distance classes (Thirdparty/fbow/fbow.h:206+).  Instead of one
distance at a time, we compute whole [N, M] distance matrices:
XOR + population_count + a reduction over the 8 uint32 words, which XLA
fuses into a single elementwise pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_DIST = 256  # distances are in [0, 256]; use as +inf sentinel


# N*M from which the matmul form is used.  The threshold predates the
# H100; both forms' timings there are in PERF.md.
MATMUL_FORM_MIN_PAIRS = 1 << 20


def _unpack_bits_bf16(x: jax.Array) -> jax.Array:
    """[N, 8] uint32 → [N, 256] bf16 of {0, 1} bits."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (x[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(x.shape[0], 8 * 32).astype(jnp.bfloat16)


def hamming_matrix(a: jax.Array, b: jax.Array) -> jax.Array:
    """[N, 8] uint32 × [M, 8] uint32 → [N, M] int32 Hamming distances.

    Two exact forms:
    * small N·M — static word loop with an [N, M] int32 accumulator
      (the broadcast ``popcount(a[:,None,:] ^ b[None,:,:]).sum(-1)``
      form materializes [N, M, 8] intermediates that XLA does not fuse).
    * large N·M (≥ 2²⁰ pairs, e.g. the [4096, 1024] fuse/tracking
      matchers) — bit-unpack to {0,1} bf16 and use a matrix product:
      d(a,b) = |a| + |b| − 2·a·bᵀ.  Counts ≤ 256 are exactly
      representable in bf16 and the product accumulates in f32, so the
      result is bit-identical to the popcount path (asserted in
      tests/test_matching.py); HBM traffic drops from eight [N, M]
      accumulation passes to one [N, 256]·[256, M] matmul.
    """
    if a.shape[0] * b.shape[0] >= MATMUL_FORM_MIN_PAIRS:
        return hamming_matrix_matmul(a, b)
    return hamming_matrix_popcount(a, b)


def hamming_matrix_matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """The matmul form of :func:`hamming_matrix`, at any size."""
    A = _unpack_bits_bf16(a)
    B = _unpack_bits_bf16(b)
    pa = jnp.sum(A, axis=1, dtype=jnp.float32)
    pb = jnp.sum(B, axis=1, dtype=jnp.float32)
    ab = jax.lax.dot_general(
        A, B, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT)  # {0,1} ops: exact
    return (pa[:, None] + pb[None, :] - 2.0 * ab).astype(jnp.int32)


def hamming_matrix_popcount(a: jax.Array, b: jax.Array) -> jax.Array:
    """The word-loop popcount form of :func:`hamming_matrix`."""
    acc = jnp.zeros((a.shape[0], b.shape[0]), jnp.int32)
    for k in range(a.shape[-1]):
        x = a[:, k][:, None] ^ b[:, k][None, :]
        acc = acc + jax.lax.population_count(x).astype(jnp.int32)
    return acc


def hamming_pairwise(a: jax.Array, b: jax.Array) -> jax.Array:
    """[..., 8] × [..., 8] → [...] elementwise distances."""
    return jnp.sum(jax.lax.population_count(a ^ b), axis=-1).astype(jnp.int32)


def masked_hamming_matrix(a: jax.Array, a_valid: jax.Array,
                          b: jax.Array, b_valid: jax.Array) -> jax.Array:
    """Hamming matrix with invalid rows/cols forced to MAX_DIST."""
    d = hamming_matrix(a, b)
    mask = a_valid[:, None] & b_valid[None, :]
    return jnp.where(mask, d, MAX_DIST)
