"""Random-hyperplane LSH ops.

The reference computes per-vector hash bits in a scalar loop
(hybrid/lsh.go:95-116). Here: hashing T tables x B bits for N
vectors is ONE [N, D] x [D, T*B] matmul plus a sign/bit-pack epilogue.

Deliberate fix (SURVEY.md §7.4): the reference "normalizes" hyperplanes
by dividing by the SQUARED norm (lsh.go:85); we normalize correctly
(irrelevant for sign bits, but the planes are reusable elsewhere).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def make_hyperplanes(num_tables: int, num_bits: int, dim: int,
                     seed: int = 42) -> np.ndarray:
    """[T, B, D] unit-norm random hyperplanes (reference seeds 42,
    lsh.go:64)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((num_tables, num_bits, dim)).astype(np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True) + 1e-30
    return h


def np_hash_codes(vectors: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of hash_codes — the latency tier hashes small
    query batches without a device round-trip. Bit-for-bit the same
    packing; a projection landing EXACTLY on 0.0 could in principle
    sign differently between BLAS and XLA summation orders, which for
    LSH means a different (equally valid) bucket probe."""
    T, B, D = planes.shape
    proj = np.asarray(vectors, np.float32) @ planes.reshape(T * B, D).T
    bits = (proj > 0).reshape(-1, T, B).astype(np.int64)
    return np.sum(bits << np.arange(B, dtype=np.int64)[None, None, :],
                  axis=-1)


@functools.partial(jax.jit, static_argnames=())
def hash_codes(vectors: jnp.ndarray, planes: jnp.ndarray) -> jnp.ndarray:
    """Pack sign bits into per-table int64 codes.

    vectors: [N, D]; planes: [T, B, D] -> codes int64 [N, T].
    bit b of table t = sign(<v, planes[t, b]>) (lsh.go:95-116, batched).
    """
    T, B, D = planes.shape
    if B > 30:
        raise ValueError("num_bits must be <= 30 (int32 packing)")
    flat = planes.reshape(T * B, D)
    proj = jax.lax.dot_general(
        vectors.astype(jnp.float32), flat,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)          # [N, T*B]
    bits = (proj > 0).reshape(-1, T, B).astype(jnp.int32)
    weights = jnp.left_shift(jnp.int32(1), jnp.arange(B, dtype=jnp.int32))
    return jnp.sum(bits * weights[None, None, :], axis=-1)  # [N, T]
