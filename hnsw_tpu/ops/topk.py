"""Top-k selection ops.

The reference's bounded result/candidate heaps (heap/heap.go:42-95,
graph.go:107-160) collapse into ``lax.top_k`` over fixed-width score
rows. For exact search over large N we stream the score matrix in
chunks with a running top-k merge (O(Q*(k+chunk)) memory instead of
O(Q*N)); ``ops/pallas_exact`` fuses the same scan into one kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnsw_tpu.ops.distance import INF_DIST, pairwise_dist


def topk_smallest(dists: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Smallest-k along the last axis. Returns (dists [.., k], idx [.., k])."""
    neg, idx = jax.lax.top_k(-dists, k)
    return -neg, idx


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two top-k candidate sets (per row) into one top-k."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    dk, pos = topk_smallest(d, k)
    ik = jnp.take_along_axis(i, pos, axis=-1)
    return dk, ik


@functools.partial(jax.jit,
                   static_argnames=("k", "metric", "chunk", "fast_math"))
def exact_topk(queries: jnp.ndarray, vectors: jnp.ndarray,
               v_sq: jnp.ndarray, valid: jnp.ndarray,
               k: int, metric: str = "cosine",
               chunk: int = 16384, fast_math: bool = False
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN: brute-force scan of all vectors.

    Batched equivalent of the reference ExactIndex linear scan
    (hybrid/exact.go:61-111): one call scores Q queries against N
    vectors via chunked matmuls with a running top-k.

    queries: [Q, D]; vectors: [N, D]; v_sq: [N]; valid: [N] bool.
    Returns (dists [Q, k], indices [Q, k]); invalid rows get INF_DIST/-1.

    ``fast_math`` scans with bf16 operands (f32 accumulation), keeps a
    widened candidate set per chunk (k + max(4, k // 8)), selects once
    over the stacked per-chunk winners and reranks them in f32 at
    HIGHEST. Results stay exact-ordered except for candidates the bf16
    scan dropped from the widened set entirely.
    """
    n = vectors.shape[0]
    q = queries.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    if fast_math:
        # the per-chunk [Q, chunk] f32 score block is the memory bound
        # (2 GiB at Q = 8192 x 65536): halve the chunk for larger Q
        k_scan = min(k + max(4, k // 8), n)
        chunk = 65536 if q.shape[0] <= 8192 else 32768
    else:
        k_scan = k

    def score(vec, sq, vld):
        if fast_math:
            gram = jax.lax.dot_general(
                q.astype(jnp.bfloat16), vec.astype(jnp.bfloat16),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
            from hnsw_tpu.ops.distance import _epilogue
            d = _epilogue(metric, gram, q_sq, sq)
        else:
            d = pairwise_dist(q, vec, v_sq=sq, q_sq=q_sq, metric=metric)
        return jnp.where(vld[None, :], d, INF_DIST)

    if n <= chunk:
        d = score(vectors, v_sq, valid)
        dk, ik = topk_smallest(d, min(k_scan, n))
    else:
        # Chunked scan with running top-k merge.
        n_pad = ((n + chunk - 1) // chunk) * chunk
        pad = n_pad - n
        vpad = jnp.pad(vectors, ((0, pad), (0, 0)))
        sqpad = jnp.pad(v_sq, (0, pad))
        vldpad = jnp.pad(valid, (0, pad), constant_values=False)
        n_chunks = n_pad // chunk
        vc = vpad.reshape(n_chunks, chunk, -1)
        sc = sqpad.reshape(n_chunks, chunk)
        lc = vldpad.reshape(n_chunks, chunk)

        kk = min(k_scan, chunk)
        bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
        if fast_math and n_chunks * kk <= 8192:
            # stack per-chunk winners and select ONCE at the end instead
            # of a running merge (one top_k per chunk fewer)
            def body(_, xs):
                vec, sq, vld, base = xs
                d = score(vec, sq, vld)
                dk, ik = topk_smallest(d, kk)
                return 0, (dk, ik + base)

            _, (dks, iks) = jax.lax.scan(body, 0, (vc, sc, lc, bases))
            d_all = jnp.moveaxis(dks, 0, 1).reshape(q.shape[0], -1)
            i_all = jnp.moveaxis(iks, 0, 1).reshape(q.shape[0], -1)
            dk, pos = topk_smallest(d_all, min(kk, d_all.shape[1]))
            ik = jnp.take_along_axis(i_all, pos, axis=1)
        else:
            init_d = jnp.full((q.shape[0], kk), INF_DIST, jnp.float32)
            init_i = jnp.full((q.shape[0], kk), -1, jnp.int32)

            def body(carry, xs):
                best_d, best_i = carry
                vec, sq, vld, base = xs
                d = score(vec, sq, vld)
                dk, ik = topk_smallest(d, kk)
                ik = ik + base
                best_d, best_i = merge_topk(best_d, best_i, dk, ik, kk)
                return (best_d, best_i), None

            (dk, ik), _ = jax.lax.scan(body, (init_d, init_i),
                                       (vc, sc, lc, bases))

    if fast_math:
        # f32 rerank of the widened bf16 pool -> exact final ordering.
        # Rows whose SELECTED distance was INF are masked-out candidates
        # (dead/filtered/padded) returned as fillers with indices >= 0:
        # masking on ik alone would let the rerank recompute their true
        # distance and resurrect them into the top-k.
        was_masked = dk >= INF_DIST
        safe = jnp.clip(ik, 0, n - 1)
        cv = vectors[safe].astype(jnp.float32)          # [Q, kk, D]
        csq = v_sq[safe]
        from hnsw_tpu.ops.distance import gathered_dist
        d = gathered_dist(q, cv, csq, q_sq, metric=metric,
                          precision=jax.lax.Precision.HIGHEST)
        d = jnp.where((ik >= 0) & ~was_masked, d, INF_DIST)
        dk, pos = topk_smallest(d, min(k, d.shape[1]))
        ik = jnp.take_along_axis(ik, pos, axis=1)

    if k > dk.shape[1]:  # pad when fewer vectors than k
        pad = k - dk.shape[1]
        dk = jnp.pad(dk, ((0, 0), (0, pad)), constant_values=INF_DIST)
        ik = jnp.pad(ik, ((0, 0), (0, pad)), constant_values=-1)
    dk, ik = dk[:, :k], ik[:, :k]
    ik = jnp.where(dk >= INF_DIST, -1, ik)
    return dk, ik


def np_exact_topk(queries: np.ndarray, vectors: np.ndarray, k: int,
                  metric: str = "cosine") -> Tuple[np.ndarray, np.ndarray]:
    """Host-side exact k-NN oracle (ground truth for recall harnesses,
    mirroring hybrid/benchmark_test.go:273's pattern)."""
    from hnsw_tpu.ops.distance import np_pairwise_dist
    d = np_pairwise_dist(queries, vectors, metric)
    k = min(k, vectors.shape[0])
    idx = np.argpartition(d, k - 1, axis=1)[:, :k]
    dd = np.take_along_axis(d, idx, axis=1)
    order = np.argsort(dd, axis=1, kind="stable")
    return np.take_along_axis(dd, order, axis=1), np.take_along_axis(idx, order, axis=1)


def quantized_topk_candidates(queries: jnp.ndarray, table: jnp.ndarray,
                              scales: "jnp.ndarray | None",
                              v_sq: jnp.ndarray, valid: jnp.ndarray,
                              kk: int, metric: str = "cosine",
                              chunk: int = 65536
                              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Approximate top-kk candidate scan over a reduced-precision HBM
    table — the exact tier's CAPACITY mode (ExactIndex hbm_dtype).

    ``table`` is [N, D] bfloat16 or float16 (scales=None) or int8 with
    per-row ``scales`` [N] f32 such that row_f32 ~= row_int8 * scale.
    int8 rows are dequantized to bf16 per chunk ON DEVICE (a transient
    [chunk, D] tile), so device memory holds 1 byte/dim while the matmul
    runs on bf16 operands. A float16 table is upcast per chunk and scored
    at Precision.HIGH: 11 significand bits, ~8x bf16's, at the same 2
    bytes/dim — the rung for tightly clustered data whose separations
    drown in bf16 rounding. On a GPU, HIGH runs as TF32, whose 10 stored
    significand bits hold every fp16 value exactly, so only the query is
    rounded (to fp16's precision); an fp16 x fp16 dot with f32
    accumulation measured slower on the H100 at equal recall. ``v_sq``
    keeps the EXACT f32 squared norms (4 bytes/row), so cosine/l2
    epilogues use true norms with approximate dot products.

    Returns (approx_dists [Q, kk], indices [Q, kk]); callers restore
    exact ordering by reranking the kk winners in f32 against the host
    store (utils/rerank.host_rerank). Each chunk keeps its top-kk and
    one top_k over the stacked winners makes the final selection.
    """
    n = table.shape[0]
    q = queries.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    from hnsw_tpu.ops.distance import _epilogue

    fp16 = scales is None and table.dtype == jnp.float16
    q_bf = q.astype(jnp.bfloat16)

    def score(tab, sc, sq, vld):
        if fp16:
            gram = jax.lax.dot_general(
                q, tab.astype(jnp.float32),
                dimension_numbers=(((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGH,
                preferred_element_type=jnp.float32)
        else:
            gram = jax.lax.dot_general(
                q_bf, tab.astype(jnp.bfloat16),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
        if sc is not None:
            gram = gram * sc[None, :]
        d = _epilogue(metric, gram, q_sq, sq)
        return jnp.where(vld[None, :], d, INF_DIST)

    kk = min(kk, n)
    if n <= chunk:
        d = score(table, scales, v_sq, valid)
        return topk_smallest(d, kk)
    n_pad = ((n + chunk - 1) // chunk) * chunk
    pad = n_pad - n
    if pad:
        tab = jnp.pad(table, ((0, pad), (0, 0)))
        sq = jnp.pad(v_sq, (0, pad))
        vld = jnp.pad(valid, (0, pad), constant_values=False)
        sc = None if scales is None else jnp.pad(scales, (0, pad))
    else:
        # this runs EAGERLY (callers pass multi-GB tables; jitting
        # would re-trace per shape anyway): a zero pad would still
        # materialize a full copy of the table. Alias when aligned.
        tab, sq, vld, sc = table, v_sq, valid, scales
    n_chunks = n_pad // chunk
    m = min(kk, chunk)
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    tab = tab.reshape(n_chunks, chunk, -1)
    sq = sq.reshape(n_chunks, chunk)
    vld = vld.reshape(n_chunks, chunk)
    sc = None if sc is None else sc.reshape(n_chunks, chunk)

    def body(_, xs):
        if sc is None:
            t, s, v, base = xs
            d = score(t, None, s, v)
        else:
            t, c, s, v, base = xs
            d = score(t, c, s, v)
        dm, im = topk_smallest(d, m)
        return 0, (dm, im + base)

    xs = (tab, sq, vld, bases) if sc is None else (tab, sc, sq, vld, bases)
    _, (dms, ims) = jax.lax.scan(body, 0, xs)
    d_all = jnp.moveaxis(dms, 0, 1).reshape(q.shape[0], -1)
    i_all = jnp.moveaxis(ims, 0, 1).reshape(q.shape[0], -1)
    dk, pos = topk_smallest(d_all, min(kk, d_all.shape[1]))
    ik = jnp.take_along_axis(i_all, pos, axis=1)
    return dk, ik
