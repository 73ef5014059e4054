"""Batched distance ops — the device replacement for the reference's
SIMD distance kernels (reference: distance.go:15-22, backed by viterin/vek
Go-assembly; SURVEY.md §2.8).

Design: every distance in this engine is computed through ONE matmul
(``queries @ vectors.T``) plus a cheap elementwise epilogue. Cosine / L2
/ squared-L2 / dot are all epilogues over the same Gram block:

    cosine(a,b)      = 1 - <a,b> / (|a||b|)          (distance.go:16)
    l2(a,b)          = sqrt(|a|^2 + |b|^2 - 2<a,b>)  (distance.go:21)
    sqeuclidean(a,b) = |a|^2 + |b|^2 - 2<a,b>
    dot(a,b)         = -<a,b>            (inner-product search ordering)

Squared norms are cached alongside the vector store so the epilogue never
re-reads the vectors. A distance-function registry mirrors the reference's
``RegisterDistanceFunc`` (distance.go:25-46) for checkpoint round-trips.

Numerical note: the Gram-based l2 epilogue (|a|^2+|b|^2-2ab) cancels
catastrophically when coordinates are huge relative to neighbor gaps
(|x| ~ 1e4 in f32) — the standard trade of this formulation (FAISS
makes the same one). Embedding-scale data (normalized or O(1..100)
coordinates) is unaffected; center/rescale pathological inputs.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hnsw_tpu.config import canonical_metric

# Large-but-finite sentinel: masked / invalid entries get this distance.
# Finite so that lax.top_k comparisons and f32 arithmetic stay NaN-free.
INF_DIST = np.float32(3.0e38)

_EPS = 1e-30


def sq_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Row-wise squared norms, f32."""
    x = x.astype(jnp.float32)
    return jnp.sum(x * x, axis=-1)


def _epilogue(metric: str, qv: jnp.ndarray, q_sq: jnp.ndarray,
              v_sq: jnp.ndarray) -> jnp.ndarray:
    """Turn a Gram block ``qv = Q @ V.T`` into distances.

    q_sq: [..., Q] squared norms of queries (broadcast over trailing axis)
    v_sq: [..., N] squared norms of the scored vectors.
    """
    if metric == "cosine":
        denom = jax.lax.rsqrt(q_sq[..., None] * v_sq[..., None, :] + _EPS)
        return 1.0 - qv * denom
    if metric == "sqeuclidean":
        d = q_sq[..., None] + v_sq[..., None, :] - 2.0 * qv
        return jnp.maximum(d, 0.0)
    if metric == "l2":
        d = q_sq[..., None] + v_sq[..., None, :] - 2.0 * qv
        return jnp.sqrt(jnp.maximum(d, 0.0))
    if metric == "dot":
        return -qv
    raise ValueError(f"unknown metric {metric}")


def pairwise_dist(queries: jnp.ndarray, vectors: jnp.ndarray,
                  v_sq: Optional[jnp.ndarray] = None,
                  q_sq: Optional[jnp.ndarray] = None,
                  metric: str = "cosine",
                  precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Dense [Q, N] distance block via one matmul.

    This is the hot op of exact search and of every HNSW hop. ``precision``
    defaults to HIGHEST (f32-accurate) for ground-truth exactness; HNSW
    traversal may pass DEFAULT for speed (TF32 for f32 operands on a
    GPU) — ANN ordering tolerates it.
    """
    metric = canonical_metric(metric)
    qf = queries.astype(jnp.float32)
    vf = vectors.astype(jnp.float32)
    spec = _registry.get(metric)
    if spec is not None:
        return _custom_pairwise_jax(metric, spec)(qf, vf)
    if q_sq is None:
        q_sq = sq_norms(qf)
    if v_sq is None:
        v_sq = sq_norms(vf)
    qv = jax.lax.dot_general(
        qf, vf,
        dimension_numbers=(((qf.ndim - 1,), (vf.ndim - 1,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )
    return _epilogue(metric, qv, q_sq, v_sq)


def gathered_dist(queries: jnp.ndarray, cand_vecs: jnp.ndarray,
                  cand_sq: jnp.ndarray, q_sq: jnp.ndarray,
                  metric: str = "cosine",
                  precision=jax.lax.Precision.DEFAULT) -> jnp.ndarray:
    """Distances from each query to ITS OWN candidate set.

    queries:   [B, D]
    cand_vecs: [B, C, D]   (gathered per-query neighbor vectors)
    cand_sq:   [B, C]
    q_sq:      [B]
    returns    [B, C]

    This is the per-hop scoring op of batched HNSW beam search — the
    collapse of the reference's ParallelSearch goroutine fan-out
    (graph.go:736-790) into a single batched contraction.
    """
    metric = canonical_metric(metric)
    qf = queries.astype(jnp.float32)
    cf = cand_vecs.astype(jnp.float32)
    spec = _registry.get(metric)
    if spec is not None:
        pw = _custom_pairwise_jax(metric, spec)
        return jax.vmap(lambda qq, cc: pw(qq[None, :], cc)[0])(qf, cf)
    qv = jnp.einsum("bd,bcd->bc", qf, cf, precision=precision)
    if metric == "cosine":
        denom = jax.lax.rsqrt(q_sq[:, None] * cand_sq + _EPS)
        return 1.0 - qv * denom
    if metric == "sqeuclidean":
        return jnp.maximum(q_sq[:, None] + cand_sq - 2.0 * qv, 0.0)
    if metric == "l2":
        return jnp.sqrt(jnp.maximum(q_sq[:, None] + cand_sq - 2.0 * qv, 0.0))
    if metric == "dot":
        return -qv
    raise ValueError(f"unknown metric {metric}")


def point_dist(a, b, metric: str = "cosine") -> float:
    """Scalar distance between two vectors (host convenience; mirrors the
    reference's DistanceFunc call signature, distance.go:12)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    metric = canonical_metric(metric)
    spec = _registry.get(metric)
    if spec is not None:
        return float(spec["point"](a, b))
    ab = float(np.dot(a, b))
    if metric == "cosine":
        na = float(np.dot(a, a))
        nb = float(np.dot(b, b))
        return 1.0 - ab / np.sqrt(na * nb + _EPS)
    if metric == "sqeuclidean":
        return max(float(np.dot(a - b, a - b)), 0.0)
    if metric == "l2":
        return float(np.sqrt(max(np.dot(a - b, a - b), 0.0)))
    if metric == "dot":
        return -ab
    raise ValueError(metric)


def np_gram_epilogue(qv: np.ndarray, q_sq, c_sq,
                     metric: str) -> np.ndarray:
    """Distances from a precomputed Gram block — the host twin of the
    device epilogues above, for callers that already hold qv and the
    squared norms (candidate reranks, chunked oracle scans, bucket
    scans).  ``q_sq``/``c_sq`` must broadcast against ``qv``.  One
    epsilon convention for every site (the per-site copies this
    replaces had drifted on where 1e-30 was applied).  ``metric`` must
    be a canonical builtin name."""
    if metric == "dot":
        return -qv
    if metric == "cosine":
        return 1.0 - qv / np.sqrt(q_sq * c_sq + _EPS)
    d = np.maximum(q_sq + c_sq - 2.0 * qv, 0.0)
    if metric == "l2":
        d = np.sqrt(d)
    return d


def np_pairwise_dist(queries: np.ndarray, vectors: np.ndarray,
                     metric: str = "cosine") -> np.ndarray:
    """NumPy [Q, N] distances — host-side oracle / builder helper."""
    metric = canonical_metric(metric)
    q = np.asarray(queries, np.float32)
    v = np.asarray(vectors, np.float32)
    spec = _registry.get(metric)
    if spec is not None:
        if spec["pairwise"] is not None:
            return np.asarray(spec["pairwise"](q, v), np.float32)
        return np.array([[spec["point"](qq, vv) for vv in v] for qq in q],
                        np.float32)
    qv = q @ v.T
    if metric == "dot":
        return -qv
    q_sq = np.sum(q * q, axis=-1)
    v_sq = np.sum(v * v, axis=-1)
    if metric == "cosine":
        denom = np.sqrt(q_sq[:, None] * v_sq[None, :] + _EPS)
        return 1.0 - qv / denom
    d = np.maximum(q_sq[:, None] + v_sq[None, :] - 2.0 * qv, 0.0)
    if metric == "sqeuclidean":
        return d
    return np.sqrt(d)


# ---------------------------------------------------------------------------
# Distance registry — mirrors reference RegisterDistanceFunc
# (distance.go:25-46): names are what checkpoints store, so custom metrics
# must be registered before Import.
# ---------------------------------------------------------------------------

#: name -> epilogue spec. Builtin metrics are closed-form epilogues over the
#: Gram matrix; custom entries provide a host-side DistanceFunc and an
#: optional batched JAX implementation.
_registry: Dict[str, dict] = {}


def _custom_pairwise_jax(name: str, spec: dict) -> Callable:
    """The JAX pairwise fn of a registered metric, or a clear error.

    Device paths (Graph search/build, ExactIndex) trace the distance
    under jit, so a host-only point_fn cannot serve them."""
    pw = spec.get("pairwise")
    if pw is None:
        raise ValueError(
            f"custom metric {name!r} was registered without a JAX "
            f"pairwise_fn; device search/build requires one — "
            f"register_distance({name!r}, point_fn, pairwise_fn=...)")
    return pw


def register_distance(name: str,
                      point_fn: Callable[[np.ndarray, np.ndarray], float],
                      pairwise_fn: Optional[Callable] = None) -> None:
    """Register a custom distance under ``name`` (reference:
    RegisterDistanceFunc, distance.go:44). The name becomes a valid
    ``metric=`` everywhere a builtin is (Graph, ExactIndex, checkpoint
    round-trips).

    ``point_fn(a, b) -> float`` is required (host oracle).
    ``pairwise_fn(Q [Q,D], V [N,D]) -> [Q,N]`` must be JAX-traceable and
    is required for any device path (Graph search/build, ExactIndex) —
    without it only host-side helpers work. Larger = farther; returned
    distances must stay finite and below ~3e38 (INF_DIST is the masked
    sentinel).
    """
    from hnsw_tpu.config import METRICS
    if name.lower() in METRICS or name.lower() == "euclidean":
        raise ValueError(f"cannot override builtin metric {name!r}")
    _registry[name] = {"point": point_fn, "pairwise": pairwise_fn}


def resolve_metric(name: str) -> str:
    """Validate a metric name is either builtin or registered."""
    try:
        return canonical_metric(name)
    except ValueError:
        if name in _registry:
            return name
        raise


def registered(name: str) -> Optional[dict]:
    return _registry.get(name)
