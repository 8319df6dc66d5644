"""Bag-of-words transform + scoring as batched XLA ops.

Replaces fbow's SIMD tree descent and scoring (Thirdparty/fbow/fbow.h:38,
84-114; called from Frame::ComputeFboW, src/Frame.cc:395): word assignment
is a per-level gather + Hamming argmin over k children, tf-idf vectors are
dense [n_words] arrays, and similarity is a dot product — so scoring one
query against the whole keyframe database is a single matmul
(models/keyframe_db.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.models.vocabulary import Vocabulary
from orbslam2_tpu.ops import hamming


def descriptors_to_words(voc: Vocabulary, desc: jax.Array,
                         valid: jax.Array) -> jax.Array:
    """[N, 8] uint32 → [N] int32 word ids (invalid → n_words sentinel)."""
    cents = [jnp.asarray(c) for c in voc.centroids]
    n = desc.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    for d in range(voc.levels):
        child_ids = node[:, None] * voc.k + jnp.arange(voc.k, dtype=jnp.int32)
        cand = cents[d][child_ids]                    # [N, k, 8]
        dist = jnp.sum(jax.lax.population_count(
            desc[:, None, :] ^ cand), axis=-1)        # [N, k]
        node = child_ids[jnp.arange(n), jnp.argmin(dist, axis=-1)]
    return jnp.where(valid, node, voc.n_words)


def bow_vector(voc: Vocabulary, desc: jax.Array, valid: jax.Array
               ) -> jax.Array:
    """[N, 8] descriptors → L2-normalized tf-idf vector [n_words]."""
    words = descriptors_to_words(voc, desc, valid)
    counts = jnp.zeros((voc.n_words,), jnp.float32).at[words].add(
        valid.astype(jnp.float32))
    tf = counts / jnp.maximum(jnp.sum(counts), 1.0)
    v = tf * jnp.asarray(voc.idf)
    norm = jnp.linalg.norm(v)
    return v / jnp.where(norm < 1e-12, 1.0, norm)


def score(a: jax.Array, b: jax.Array) -> jax.Array:
    """Similarity of two normalized BoW vectors in [0, 1] (the role of
    fBow::score, fbow.h:38)."""
    return jnp.dot(a, b)
