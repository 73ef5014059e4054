"""Batched hierarchical beam search — the engine's hot path.

Accelerator redesign of the reference's greedy beam search
(graph.go:94-170 ``layerNode.search``) and layer descent
(graph.go:534-625 ``Graph.Search``): instead of one pointer-chase with
Go heaps per query, B queries traverse the graph in lockstep. Each hop:

  1. select each query's best unexpanded pool entry       (argmin)
  2. gather its M neighbor ids + vectors                  (HBM gather)
  3. score all B*M candidates at once                     (einsum)
  4. merge into the per-query pool with lax.top_k         (sort)

The bounded result/candidate heap pair of the reference becomes a single
fixed-width pool of size P = max(ef, k) with per-entry "expanded" flags —
the classic array formulation of HNSW searchLayer. Termination matches
the reference's no-improvement rule (graph.go:164-166): a query goes
inactive when its best unexpanded candidate is no better than its worst
pool entry; a static max_hops bounds the XLA while_loop.

The reference's ParallelSearch worker fan-out (graph.go:631-826) is
subsumed: batching IS the parallelism.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnsw_tpu.config import canonical_metric
from hnsw_tpu.core.state import DeviceGraph
from hnsw_tpu.ops.distance import (INF_DIST, gathered_dist, pairwise_dist,
                                   registered)


#: bit 30 of the merge-sort id operand carries the "expanded" flag
#: (slot ids are dense int32 << 2^30; -1 sentinels stay negative).
_EXP_BIT = np.int32(1 << 30)


def _dedup_adjacent(pool_d, pool_i, expanded):
    """Mask duplicate ids in a distance-sorted pool.

    Duplicate ids always carry equal distances, so after a stable top_k
    they are adjacent (lax.top_k breaks ties by index, keeping the
    earlier — pool-resident — copy first). The only escape is a distinct
    node tying the exact same float distance AND interleaving, which is
    measure-zero on real data; search_graph runs one final full pass
    anyway. Masked slots get (INF, -1, expanded=True) and are pushed out
    at the next merge."""
    dup = jnp.concatenate(
        [jnp.zeros((pool_i.shape[0], 1), bool),
         (pool_i[:, 1:] == pool_i[:, :-1]) & (pool_i[:, 1:] >= 0)],
        axis=1)
    return (jnp.where(dup, INF_DIST, pool_d),
            jnp.where(dup, -1, pool_i),
            expanded | dup)


def _bitonic_merge(pool_d, pool_i, cand_d, cand_i, P: int):
    """Merge a sorted pool with a narrow candidate block — O(W log C +
    W log W) compare-exchanges instead of lax.sort's full O(W log^2 W)
    network over the concatenation.

    pool_d/pool_i [B, P] sorted ascending; cand_d/cand_i [B, C]
    unsorted. Ids are moved opaquely (flag bits survive). Returns the
    best P entries sorted ascending. Exactness: sorting the candidates
    ascending, reversing them, and appending to the ascending pool
    (with an INF plateau from padding in between) forms a bitonic
    sequence, so log2(W) compare-exchange stages sort it fully.
    Duplicate ids still carry equal distances and land adjacent, which
    is all _dedup_adjacent needs (the merge is not stable, but
    in-pool candidates are masked before scoring, so duplicates are
    only same-hop diamond twins — indistinguishable copies).
    """
    B, C = cand_d.shape
    cd, ci = jax.lax.sort((cand_d, cand_i), dimension=1, num_keys=1,
                          is_stable=True)
    W = P + C
    W2 = 1 << (W - 1).bit_length()
    pad = W2 - W
    if pad:
        cd = jnp.pad(cd, ((0, 0), (0, pad)), constant_values=INF_DIST)
        ci = jnp.pad(ci, ((0, 0), (0, pad)), constant_values=-1)
    d = jnp.concatenate([pool_d, cd[:, ::-1]], axis=1)
    i = jnp.concatenate([pool_i, ci[:, ::-1]], axis=1)
    s = W2 // 2
    while s >= 1:
        d4 = d.reshape(B, -1, 2, s)
        i4 = i.reshape(B, -1, 2, s)
        a_d, b_d = d4[:, :, 0], d4[:, :, 1]
        a_i, b_i = i4[:, :, 0], i4[:, :, 1]
        swap = a_d > b_d
        lo_d = jnp.where(swap, b_d, a_d)
        hi_d = jnp.where(swap, a_d, b_d)
        lo_i = jnp.where(swap, b_i, a_i)
        hi_i = jnp.where(swap, a_i, b_i)
        d = jnp.stack([lo_d, hi_d], axis=2).reshape(B, W2)
        i = jnp.stack([lo_i, hi_i], axis=2).reshape(B, W2)
        s //= 2
    return d[:, :P], i[:, :P]


def _score_hop(g: DeviceGraph, queries, q_sq, nb_safe, metric, precision):
    """Distances from each query to its gathered candidate slots.

    Preference order: f32 row gathers when real vectors are in HBM —
    XLA row gathers are bound by the number of rows, not their bytes,
    so int8 rows are not faster (layout + convert); int8's value is HBM
    capacity. The int8
    store serves scoring only in the capacity mode (g.vectors is the
    [1, D] placeholder). The per-row dequant scale folds into the Gram
    epilogue, never touching the [B, C, D] tensor. Custom registered
    metrics always consume raw vectors.
    """
    if (g.qvec is not None and g.vectors.shape[0] <= 1
            and registered(metric) is None):
        cq = g.qvec[nb_safe]                         # [B, C, D] int8
        qv = jnp.einsum("bd,bcd->bc", queries.astype(jnp.bfloat16),
                        cq.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        qv = qv * g.qscale[nb_safe]
        if metric == "dot":
            return -qv
        cand_sq = g.sq_norms[nb_safe]
        if metric == "cosine":
            return 1.0 - qv * jax.lax.rsqrt(
                q_sq[:, None] * cand_sq + 1e-30)
        d = jnp.maximum(q_sq[:, None] + cand_sq - 2.0 * qv, 0.0)
        return jnp.sqrt(d) if metric == "l2" else d
    cand_vecs = g.vectors[nb_safe]
    cand_sq = g.sq_norms[nb_safe]
    if cand_vecs.dtype == jnp.float16:
        # fp16 capacity store: its whole value is the 11 mantissa bits
        # that route through tight clusters — don't let fast_math's
        # DEFAULT precision round the scoring pass below them (a GPU
        # runs f32 operands at DEFAULT as TF32: 10 bits). The hop is
        # gather-bound; the einsum cost difference is noise (same
        # reasoning as the fp16 neighbor-block path above).
        precision = jax.lax.Precision.HIGHEST
    return gathered_dist(queries, cand_vecs, cand_sq, q_sq,
                         metric=metric, precision=precision)


def _entry_dist(g: DeviceGraph, queries, q_sq, entry_ids, metric, precision):
    safe = jnp.clip(entry_ids, 0, g.cap - 1)
    d = _score_hop(g, queries, q_sq, safe[:, None], metric, precision)[:, 0]
    return jnp.where(entry_ids >= 0, d, INF_DIST)


def beam_search_layer(g: DeviceGraph, layer: int, queries: jnp.ndarray,
                      q_sq: jnp.ndarray, start_ids: jnp.ndarray,
                      start_d: jnp.ndarray, pool_size: int, max_hops: int,
                      metric: str, precision, expand: int = 1,
                      merge: str = "sort", store_normalized: bool = False
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Beam search one layer for a batch of queries.

    ``expand`` > 1 opens the top-E unexpanded pool entries per hop
    instead of one — fewer, fatter hops (larger gathers and einsums that
    the matrix units like) at the cost of a few extra distance
    evaluations. Classic single-candidate expansion is expand=1.

    Returns (pool_dists [B, P], pool_ids [B, P]) sorted ascending;
    empty slots are (INF_DIST, -1).
    """
    B = queries.shape[0]
    cap = g.cap
    P = pool_size
    E = max(1, min(expand, P))
    M = g.layer_width(layer)                # M0 or upper m
    rows = jnp.arange(B)
    use_blocks = (layer == 0 and g.nbr_blocks is not None
                  and registered(metric) is None)
    if use_blocks and g.nbr_blocks.shape[1] < M:
        # narrow blocks (block_m < M0): the HBM-capacity knob for very
        # large builds — the hop expands only the first block_m edges
        # of each row (rows are selection-ordered, so these are the
        # best/most diverse ones).
        M = g.nbr_blocks.shape[1]

    # NO visited set. The pool is the dedup AND termination structure:
    #   * candidates already in the pool are masked by a broadcast
    #     compare against pool ids (cheap elementwise work) before
    #     scoring;
    #   * a node evicted from the pool can never re-enter: eviction
    #     means P better entries existed, and the pool only improves;
    #   * same-hop duplicates (diamond frontiers) carry equal distances,
    #     land adjacent after the stable sort, and are masked by
    #     _dedup_adjacent — the freed slots refill at the next merge.
    # A [B, cap] bitmask / id-table would cost a [B, cap] scatter per
    # hop, far more than the gather+score itself. The price is
    # re-scoring diamond-overlap candidates.
    # Edges to dead nodes are prefolded to -1 at device-sync time
    # (state.from_host), so the hop gathers no tombstone mask either.

    # Pool init: the start node(s) occupy the leading slots (mirrors the
    # reference pushing the entry into the result set first,
    # graph.go:122). start_ids/start_d may be [B] (classic single entry)
    # or [B, S] (seeded entry — S pre-scored candidates, e.g. from a
    # pivot matmul). Tie every carry component to start_d's varying-axes
    # type: under shard_map the while_loop requires carry-in and
    # carry-out to agree on which mesh axes they vary over, and start_d
    # (a distance between query and graph) always carries the union.
    if start_ids.ndim == 1:
        start_ids = start_ids[:, None]
        start_d = start_d[:, None]
    S = min(start_ids.shape[1], P)
    vary0 = (start_d[:, 0] * 0).astype(jnp.int32)           # [B] zeros
    pool_i = (jnp.full((B, P), -1, jnp.int32)
              .at[:, :S].set(start_ids[:, :S]) + vary0[:, None])
    pool_d = (jnp.full((B, P), INF_DIST, jnp.float32)
              .at[:, :S].set(start_d[:, :S]))
    if S > 1:
        # keep the pool's sorted-ascending invariant for seeded entries
        pool_d, pool_i = jax.lax.sort((pool_d, pool_i), dimension=1,
                                      num_keys=1, is_stable=True)
        pool_d, pool_i, _ = _dedup_adjacent(pool_d, pool_i,
                                            pool_i < -1)
        if merge == "bitonic":
            # push dedup holes to the tail: the bitonic merge requires
            # a hole-free ascending pool (one-time cost at init)
            pool_d, pool_i = jax.lax.sort((pool_d, pool_i), dimension=1,
                                          num_keys=1, is_stable=True)
    expanded = pool_i < -1
    hop0 = jnp.min(vary0)

    def select(pool_d, pool_i, expanded):
        """Top-E unexpanded pool entries; take-mask per entry."""
        sel_d = jnp.where(expanded | (pool_i < 0), INF_DIST, pool_d)
        negv, j = jax.lax.top_k(-sel_d, E)                  # [B, E]
        best = -negv                                        # ascending
        worst = jnp.max(pool_d, axis=1)                     # INF when not full
        take = best < worst[:, None]                        # per-entry
        return j, take

    j0, take0 = select(pool_d, pool_i, expanded)

    def cond(state):
        _pool_d, _pool_i, _expanded, _j, take, hop = state
        return (hop < max_hops) & jnp.any(take)

    def body(state):
        pool_d, pool_i, expanded, j, take, hop = state
        cur = jnp.take_along_axis(pool_i, j, axis=1)         # [B, E]
        cur_safe = jnp.clip(jnp.where(take, cur, 0), 0, cap - 1)
        expanded = expanded.at[rows[:, None], j].max(take)

        nbrs = (g.gather_neighbors(layer, cur_safe)[..., :M]
                .reshape(B, E * M))                          # [B, E*M]
        nb_ok = (nbrs >= 0) & jnp.repeat(take, M, axis=1)
        # Mask candidates already in the pool: without this, dups of the
        # best pool entries (equal-best distances) crowd out legitimate
        # tail entries at EVERY merge and then become dedup holes — the
        # pool shrinks over hops (catastrophic on small graphs, wasted
        # slots at scale). A [B, C, P] broadcast compare is pure
        # elementwise work — unlike the scatter/gather visited
        # structures this design removed.
        in_pool = (nbrs[:, :, None] == pool_i[:, None, :]).any(-1)
        nb_ok = nb_ok & (~in_pool)
        nb_safe = jnp.clip(jnp.where(nb_ok, nbrs, 0), 0, cap - 1)

        if use_blocks:
            # ONE [M, D] block per expanded node instead of E*M row
            # gathers (row-granularity-bound; see DeviceGraph.nbr_blocks)
            blk = g.nbr_blocks[cur_safe]              # [B, E, M, D]
            if g.nbr_blocks.dtype == jnp.int8:
                qv = jnp.einsum("bd,bemd->bem",
                                queries.astype(jnp.bfloat16),
                                blk.astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32)
                qv = qv.reshape(B, E * M) * g.block_scale
                if store_normalized and metric == "cosine":
                    # pre-normalized store: ||v|| == 1 by construction,
                    # so skip the per-hop [B, E, M, D] square+reduce
                    # (the quantized-norm deviation is second-order)
                    vsq = jnp.ones((B, E * M), jnp.float32)
                else:
                    bsq = jnp.sum(jnp.square(blk.astype(jnp.bfloat16)),
                                  axis=-1).astype(jnp.float32)
                    vsq = bsq.reshape(B, E * M) * jnp.square(
                        g.block_scale)
            else:
                # fp16 blocks (tight-cluster data: int8/bf16 noise
                # drowns within-cluster separations) — score in f32 at
                # HIGHEST; the hop is gather-bound, the einsum is tiny.
                blkf = blk.astype(jnp.float32)
                qv = jnp.einsum("bd,bemd->bem", queries, blkf,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32
                                ).reshape(B, E * M)
                if store_normalized and metric == "cosine":
                    vsq = jnp.ones((B, E * M), jnp.float32)
                else:
                    vsq = jnp.sum(blkf * blkf, axis=-1).reshape(B, E * M)
            if metric == "dot":
                d = -qv
            else:
                if metric == "cosine":
                    d = 1.0 - qv * jax.lax.rsqrt(
                        q_sq[:, None] * vsq + 1e-30)
                else:
                    d = jnp.maximum(q_sq[:, None] + vsq - 2.0 * qv, 0.0)
                    if metric == "l2":
                        d = jnp.sqrt(d)
        else:
            d = _score_hop(g, queries, q_sq, nb_safe, metric, precision)
        d = jnp.where(nb_ok, d, INF_DIST)
        new_i = jnp.where(nb_ok, nbrs, -1)

        # Fused merge: ONE stable multi-operand sort replaces
        # top_k + two take_along_axis gathers.
        # The expanded flag rides in bit 30 of the id operand (ids are
        # dense slots << 2^30), so the sort moves 2 operands, not 3.
        # merge="bitonic" exploits the pool's sorted invariant: sort
        # only the narrow candidate block, then one log2(W)-stage
        # bitonic merge network.
        ei = jnp.where(expanded & (pool_i >= 0), pool_i | _EXP_BIT,
                       pool_i)
        if merge == "bitonic":
            # Same-hop diamond twins are the ONLY possible duplicates
            # (in-pool candidates were masked above), so dedup the
            # narrow candidate block by O(C^2) id equality BEFORE the
            # merge — the pool then never develops holes and its
            # ascending invariant (the merge's precondition) is
            # maintained with no per-hop full sort anywhere.
            C = new_i.shape[1]
            tri = jnp.tril(jnp.ones((C, C), bool), k=-1)
            is_dup = ((new_i[:, :, None] == new_i[:, None, :])
                      & (new_i[:, :, None] >= 0) & tri[None]).any(-1)
            d = jnp.where(is_dup, INF_DIST, d)
            new_i = jnp.where(is_dup, -1, new_i)
            pool_d, packed = _bitonic_merge(pool_d, ei, d, new_i, P)
            expanded = packed >= _EXP_BIT
            pool_i = jnp.where(packed >= 0, packed & (_EXP_BIT - 1),
                               packed)
        else:
            md = jnp.concatenate([pool_d, d], axis=1)       # [B, P+E*M]
            mi = jnp.concatenate([ei, new_i], axis=1)
            sd, si = jax.lax.sort((md, mi), dimension=1, num_keys=1,
                                  is_stable=True)
            pool_d, packed = sd[:, :P], si[:, :P]
            expanded = packed >= _EXP_BIT
            pool_i = jnp.where(packed >= 0, packed & (_EXP_BIT - 1),
                               packed)
            pool_d, pool_i, expanded = _dedup_adjacent(pool_d, pool_i,
                                                       expanded)
        j, take = select(pool_d, pool_i, expanded)
        return pool_d, pool_i, expanded, j, take, hop + 1

    state = (pool_d, pool_i, expanded, j0, take0, hop0)
    pool_d, pool_i, expanded, _, _, _ = jax.lax.while_loop(cond, body,
                                                           state)
    # Final compaction: dedup slots hold (INF, -1); one stable sort
    # pushes them to the tail and restores ascending order.
    pd, pi = jax.lax.sort((pool_d, pool_i), dimension=1, num_keys=1,
                          is_stable=True)
    pi = jnp.where(pd >= INF_DIST, -1, pi)
    return pd, pi


@functools.partial(
    jax.jit,
    static_argnames=("k", "ef", "metric", "max_hops", "fast_math",
                     "expand", "ef_upper", "device_rerank", "merge",
                     "store_normalized"))
def search_graph(g: DeviceGraph, queries: jnp.ndarray, *, k: int, ef: int,
                 metric: str = "cosine", max_hops: int = 128,
                 fast_math: bool = False, expand: int = 1,
                 ef_upper: int = 0, device_rerank: bool = True,
                 seed_ids: jnp.ndarray | None = None,
                 merge: str = "sort", store_normalized: bool = False
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full hierarchical search for a batch of queries.

    Mirrors Graph.Search's descent (graph.go:571-593): narrow beam with
    result width 1 on upper layers ("elevator"), full (ef, k) beam at
    layer 0. Returns (dists [B, k], slot ids [B, k]); -1 = no result.

    ``ef_upper`` is the upper-layer beam width. The reference keeps an
    efSearch-wide candidate heap even above layer 0 (graph.go:578-585);
    in lockstep-batched form that multiplies the whole search cost by
    the layer count, so the default (0 -> a narrow 8-wide pool, the
    classic hnswlib choice) descends cheaply — upper layers only pick
    the entry point. Pass ef_upper=ef for reference-faithful behavior.

    ``fast_math`` drops per-hop einsums to DEFAULT matmul precision
    (TF32 for f32 operands on a GPU) — fine for traversal ordering;
    final layer-0 distances are still computed at HIGHEST for exact
    reported values.

    ``device_rerank=False`` skips the f32 rerank of the pool head and
    returns traversal-ordered results — the capacity ("HBM-quantized")
    serving mode where g.vectors is a placeholder and the caller reranks
    on host against a disk-resident store (the role of the reference's
    disk-backed searchLayer, parquet/graph.go:924-1076).

    ``seed_ids`` ([B, S] slot ids, -1 padded) REPLACES the upper-layer
    descent: the layer-0 pool starts from these pre-selected candidates
    (scored here). The coarse search: one matmul over a pivot subset
    replaces pointer-hopping down HNSW's upper layers, and multiple
    entry basins help recall on hard data.
    """
    metric = canonical_metric(metric)
    precision = (jax.lax.Precision.DEFAULT if fast_math
                 else jax.lax.Precision.HIGHEST)
    B = queries.shape[0]
    queries = queries.astype(jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)
    L = g.num_layers
    P0 = max(ef, k)
    P_up = ef_upper if ef_upper > 0 else min(8, P0)

    if seed_ids is not None:
        safe = jnp.clip(seed_ids, 0, g.cap - 1)
        seed_d = _score_hop(g, queries, q_sq, safe, metric, precision)
        seed_d = jnp.where(seed_ids >= 0, seed_d, INF_DIST)
        entry_ids = jnp.where(seed_ids >= 0, seed_ids, -1)
        entry_d = seed_d
    else:
        entry_ids = jnp.broadcast_to(g.entry, (B,)).astype(jnp.int32)
        entry_d = _entry_dist(g, queries, q_sq, entry_ids, metric,
                              precision)

        # Upper layers: narrow beam, take the best as next layer's entry
        # (reference search(1, efSearch) + elevator, graph.go:578-585).
        for layer in range(L - 1, 0, -1):
            pd, pi = beam_search_layer(g, layer, queries, q_sq, entry_ids,
                                       entry_d, pool_size=P_up,
                                       max_hops=max_hops,
                                       metric=metric, precision=precision,
                                       expand=min(expand, P_up),
                                       merge=merge,
                                       store_normalized=store_normalized)
            best_i, best_d = pi[:, 0], pd[:, 0]
            keep = best_i >= 0
            entry_ids = jnp.where(keep, best_i, entry_ids)
            entry_d = jnp.where(keep, best_d, entry_d)

    pd, pi = beam_search_layer(g, 0, queries, q_sq, entry_ids, entry_d,
                               pool_size=P0, max_hops=max_hops,
                               metric=metric, precision=precision,
                               expand=expand, merge=merge,
                               store_normalized=store_normalized)
    if (device_rerank and (fast_math or g.qvec is not None)
            and g.vectors.shape[0] > 1):
        # NOTE the shape guard: in HBM-quantized capacity mode g.vectors
        # is a [1, D] placeholder — reranking against it would clamp
        # every gather to row 0 and silently corrupt distances/order
        # (callers like parallel/sharded.py don't pass
        # device_rerank=False). Mirrors _score_hop's guard.
        # f32 rerank of the head of the pool: traversal ordering ran in
        # bf16 (and/or against the int8 store); reported distances (and
        # the final top-k ordering) are recomputed at HIGHEST over a
        # small widened window.
        R = min(P0, max(2 * k, 16))
        ri = pi[:, :R]
        safe = jnp.clip(ri, 0, g.cap - 1)
        dd = gathered_dist(queries, g.vectors[safe], g.sq_norms[safe],
                           q_sq, metric=metric,
                           precision=jax.lax.Precision.HIGHEST)
        dd = jnp.where(ri >= 0, dd, INF_DIST)
        sd, si = jax.lax.sort((dd, ri), dimension=1, num_keys=1,
                              is_stable=True)
        si = jnp.where(sd >= INF_DIST, -1, si)
        return sd[:, :k], si[:, :k]
    return pd[:, :k], pi[:, :k]


@functools.partial(jax.jit, static_argnames=("s", "metric", "fast_math"))
def pivot_seeds(queries: jnp.ndarray, pvecs: jnp.ndarray, psq: jnp.ndarray,
                pids: jnp.ndarray, *, s: int, metric: str = "cosine",
                fast_math: bool = False) -> jnp.ndarray:
    """Coarse entry selection: one matmul over a pivot subset.

    queries [B, D] x pvecs [P, D] -> per-query s best pivot SLOT ids
    [B, s] (-1 = none). Feeds search_graph(seed_ids=...) — the
    replacement for HNSW's upper-layer descent (the upper layers exist
    to find a good entry; a matmul scan of ~sqrt(N)-ish pivots does
    that in one fused op instead of pointer hops).
    """
    metric = canonical_metric(metric)
    precision = (jax.lax.Precision.DEFAULT if fast_math
                 else jax.lax.Precision.HIGHEST)
    d = pairwise_dist(queries.astype(jnp.float32), pvecs, v_sq=psq,
                      metric=metric, precision=precision)     # [B, P]
    s = min(s, d.shape[1])
    neg, j = jax.lax.top_k(-d, s)
    ids = pids[j]
    return jnp.where(-neg < INF_DIST, ids, -1)
