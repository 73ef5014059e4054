"""Bulk batched graph construction — the accelerator build path.

The reference inserts strictly sequentially (each Add searches the graph
containing all previous nodes, graph.go:437-531); on an accelerator
that is the bottleneck (SURVEY.md §3.1). This module builds in WAVES:

  1. sample all insertion levels up front (same geometric law,
     maxLevel cap evaluated at each node's sequential position);
  2. per wave of W nodes: ONE batched descent over the pre-wave graph
     snapshot (construction_descent: per layer, a lockstep beam search
     on device) yields every wave-node's top-M layer candidates;
  3. intra-wave k-NN (one W x W matmul) supplies candidates among nodes
     of the same wave — recovering the edges sequential insertion would
     have created between them;
  4. vectorized host edge assembly: wave rows = top-M of (snapshot ∪
     intra-wave) candidates; reverse edges applied with worst-distance
     eviction in one grouped pass (batch_reverse_insert).

Deviation from the reference accepted by its own quality oracle
(parquet/graph_test.go:179's InDelta-style parity): wave nodes don't
observe each other's edges mid-wave, and evictees are not replenished
during bulk build (delete-repair still replenishes). Recall parity is
validated in tests/test_build.py.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnsw_tpu.config import GraphConfig, canonical_metric
from hnsw_tpu.core import host_build
from hnsw_tpu.core.search import beam_search_layer
from hnsw_tpu.core.state import DeviceGraph, bucket_pow2, from_host
from hnsw_tpu.ops.distance import (INF_DIST, np_pairwise_dist,
                                   pairwise_dist)


@functools.partial(jax.jit,
                   static_argnames=("ef", "m_out", "metric", "max_hops"))
def construction_descent(g: DeviceGraph, queries: jnp.ndarray, *, ef: int,
                         m_out: int, metric: str, max_hops: int
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched insert-search: descend all layers for W wave vectors.

    Returns (cand_d, cand_i) of shape [L, W, m_out]: per layer, each
    wave node's nearest m_out snapshot nodes (the "neighborhood" of
    graph.go:500, batched)."""
    metric = canonical_metric(metric)
    # HIGHEST: at DEFAULT a GPU runs f32 operands as TF32 (10 significand
    # bits), and on large-norm l2 data the |a|^2 + |b|^2 - 2ab
    # cancellation then swamps in-cluster gaps. The hops are
    # gather-bound, so exact f32 costs little.
    precision = jax.lax.Precision.HIGHEST
    queries = queries.astype(jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)
    W = queries.shape[0]
    L = g.num_layers

    entry_ids = jnp.broadcast_to(g.entry, (W,)).astype(jnp.int32)
    vecs = g.vectors[jnp.clip(entry_ids, 0, g.cap - 1)]
    sq = g.sq_norms[jnp.clip(entry_ids, 0, g.cap - 1)]
    from hnsw_tpu.ops.distance import gathered_dist
    entry_d = gathered_dist(queries, vecs[:, None, :], sq[:, None], q_sq,
                            metric=metric, precision=precision)[:, 0]
    entry_d = jnp.where(entry_ids >= 0, entry_d, INF_DIST)

    outs_d, outs_i = [], []
    for layer in range(L - 1, -1, -1):
        pd, pi = beam_search_layer(g, layer, queries, q_sq, entry_ids,
                                   entry_d, pool_size=ef, max_hops=max_hops,
                                   metric=metric, precision=precision,
                                   expand=4)
        outs_d.append(pd[:, :m_out])
        outs_i.append(pi[:, :m_out])
        keep = pi[:, 0] >= 0
        entry_ids = jnp.where(keep, pi[:, 0], entry_ids)
        entry_d = jnp.where(keep, pd[:, 0], entry_d)
    # outs are top-down; reorder to layer index order [0..L-1]
    outs_d.reverse()
    outs_i.reverse()
    return jnp.stack(outs_d), jnp.stack(outs_i)


@functools.partial(jax.jit, static_argnames=("metric",))
def _cand_dist_dev(vectors: jnp.ndarray, sq: jnp.ndarray,
                   anchors: jnp.ndarray, others: jnp.ndarray,
                   metric: str) -> jnp.ndarray:
    """dist(vectors[anchors[u]], vectors[others[u, k]]) -> [U, K] on
    device; -1 entries in ``others`` yield INF_DIST."""
    safe_a = jnp.clip(anchors, 0, vectors.shape[0] - 1)
    safe_o = jnp.clip(others, 0, vectors.shape[0] - 1)
    va = vectors[safe_a]                     # [U, D]
    vo = vectors[safe_o]                     # [U, K, D]
    ab = jnp.einsum("ud,ukd->uk", va, vo,
                    precision=jax.lax.Precision.HIGHEST)
    if metric == "dot":
        d = -ab
    else:
        sa = sq[safe_a][:, None]
        so = sq[safe_o]
        if metric == "cosine":
            d = 1.0 - ab * jax.lax.rsqrt(sa * so + 1e-30)
        else:
            d = jnp.maximum(sa + so - 2.0 * ab, 0.0)
            if metric == "l2":
                d = jnp.sqrt(d)
    return jnp.where((others >= 0) & (anchors[:, None] >= 0), d, INF_DIST)


@functools.partial(jax.jit,
                   static_argnames=("deg", "metric", "diversify"))
def _diverse_select_dev(cand_i: jnp.ndarray, cand_d: jnp.ndarray,
                        vectors: jnp.ndarray, sq: jnp.ndarray, *, deg: int,
                        metric: str, diversify: bool) -> jnp.ndarray:
    """Device version of diverse_select (see that docstring): sort by
    distance, dedup, Malkov-heuristic scan via fori_loop, pruned
    backfill, compact. The [P, C, C] candidate-pairwise block is one
    batched matmul."""
    P, C = cand_i.shape
    order = jnp.argsort(cand_d, axis=1, stable=True)
    ci = jnp.take_along_axis(cand_i, order, axis=1)
    cd = jnp.take_along_axis(cand_d, order, axis=1)
    dup = (ci[:, :, None] == ci[:, None, :])
    dup = jnp.tril(dup, k=-1).any(axis=2) & (ci >= 0)
    cd = jnp.where(dup, INF_DIST, cd)
    valid = (cd < INF_DIST) & (ci >= 0)

    if not diversify:
        out = jnp.where(valid[:, :deg], ci[:, :deg], -1)
        return out

    safe = jnp.clip(ci, 0, vectors.shape[0] - 1)
    pv = vectors[safe].astype(jnp.float32)          # [P, C, D]
    gram = jnp.einsum("pcd,ped->pce", pv, pv,
                      precision=jax.lax.Precision.HIGHEST)
    s = sq[safe]
    if metric == "cosine":
        pd = 1.0 - gram * jax.lax.rsqrt(s[:, :, None] * s[:, None, :] + 1e-30)
    elif metric == "dot":
        pd = -gram
    else:
        pd = jnp.maximum(s[:, :, None] + s[:, None, :] - 2.0 * gram, 0.0)
        if metric == "l2":
            pd = jnp.sqrt(pd)

    def scan_j(j, state):
        sel, count = state
        no_conflict = jnp.all(~sel | (pd[:, j, :] >= cd[:, j, None]), axis=1)
        take = valid[:, j] & no_conflict & (count < deg)
        return sel.at[:, j].set(take), count + take

    sel = jnp.zeros((P, C), bool)
    count = jnp.zeros((P,), jnp.int32)
    sel, count = jax.lax.fori_loop(0, C, scan_j, (sel, count))

    def fill_j(j, state):
        sel, count = state
        take = valid[:, j] & ~sel[:, j] & (count < deg)
        return sel.at[:, j].set(sel[:, j] | take), count + take

    sel, count = jax.lax.fori_loop(0, C, fill_j, (sel, count))

    idx = jnp.argsort(~sel, axis=1, stable=True)
    sel_s = jnp.take_along_axis(sel, idx, axis=1)[:, :deg]
    ci_s = jnp.take_along_axis(ci, idx, axis=1)[:, :deg]
    return jnp.where(sel_s, ci_s, -1)


def _np_dist_rows(vectors: np.ndarray, sq: np.ndarray, a: np.ndarray,
                  b: np.ndarray, metric: str) -> np.ndarray:
    """Pairwise distances between vectors[a[i]] and vectors[b[i]] (same
    shape index arrays, any dims)."""
    va = vectors[a]
    vb = vectors[b]
    ab = np.einsum("...d,...d->...", va, vb)
    if metric == "dot":
        return -ab
    sa = sq[a]
    sb = sq[b]
    if metric == "cosine":
        return 1.0 - ab / np.sqrt(sa * sb + 1e-30)
    d = np.maximum(sa + sb - 2.0 * ab, 0.0)
    if metric == "sqeuclidean":
        return d
    return np.sqrt(d)


def diverse_select(cand_i: np.ndarray, cand_d: np.ndarray,
                   vectors: np.ndarray, sq: np.ndarray, deg: int,
                   metric: str, diversify: bool = True) -> np.ndarray:
    """Vectorized neighbor selection for a batch of P nodes.

    With ``diversify`` (Malkov's Algorithm 4, the standard HNSW
    heuristic the reference omits): walk candidates nearest-first, keep
    one only if it is closer to the query node than to every
    already-kept neighbor, then backfill with pruned candidates. All P
    rows are processed in lockstep with one [P, C, C] distance block.

    cand_i [P, C] (-1 pad), cand_d [P, C] (inf on pads).
    Returns rows [P, deg] of selected ids, -1 padded.
    """
    order = np.argsort(cand_d, axis=1, kind="stable")
    ci = np.take_along_axis(cand_i, order, axis=1)
    cd = np.take_along_axis(cand_d, order, axis=1)
    # drop duplicate candidate ids within a row (keep nearest occurrence)
    P, C = ci.shape
    dup = np.zeros((P, C), bool)
    for j in range(1, C):
        dup[:, j] = (ci[:, j:j + 1] == ci[:, :j]).any(axis=1) & (ci[:, j] >= 0)
    cd = np.where(dup, np.inf, cd)
    valid = np.isfinite(cd) & (ci >= 0)

    if not diversify:
        out = np.where(valid[:, :deg], ci[:, :deg], -1)
        if out.shape[1] < deg:
            out = np.pad(out, ((0, 0), (0, deg - out.shape[1])),
                         constant_values=-1)
        return out

    safe = np.where(ci >= 0, ci, 0)
    pv = vectors[safe].astype(np.float32)            # [P, C, D]
    gram = np.einsum("pcd,ped->pce", pv, pv)
    s = sq[safe].astype(np.float32)
    if metric == "cosine":
        pd = 1.0 - gram / np.sqrt(s[:, :, None] * s[:, None, :] + 1e-30)
    elif metric == "dot":
        pd = -gram
    else:
        pd = np.maximum(s[:, :, None] + s[:, None, :] - 2.0 * gram, 0.0)
        if metric == "l2":
            pd = np.sqrt(pd)

    sel = np.zeros((P, C), bool)
    count = np.zeros(P, np.int64)
    for j in range(C):
        no_conflict = np.all(~sel | (pd[:, j, :] >= cd[:, j, None]), axis=1)
        take = valid[:, j] & no_conflict & (count < deg)
        sel[:, j] = take
        count += take
    for j in range(C):  # keepPrunedConnections backfill
        take = valid[:, j] & ~sel[:, j] & (count < deg)
        sel[:, j] |= take
        count += take

    # compact selected (they are in ascending-distance order already)
    idx = np.argsort(~sel, axis=1, kind="stable")
    sel_s = np.take_along_axis(sel, idx, axis=1)[:, :deg]
    ci_s = np.take_along_axis(ci, idx, axis=1)[:, :deg]
    out = np.where(sel_s, ci_s, -1)
    if out.shape[1] < deg:
        out = np.pad(out, ((0, 0), (0, deg - out.shape[1])),
                     constant_values=-1)
    return out


def _dev_pair_dist(dev_vectors, dev_sq, a: np.ndarray, b: np.ndarray,
                   metric: str) -> np.ndarray:
    """dist(a[i], b[i]) for index vectors, computed on device with
    row-count bucketing to bound recompiles."""
    E = len(a)
    Ep = bucket_pow2(max(E, 1), 256)
    ap = np.full(Ep, -1, np.int64)
    bp = np.full((Ep, 1), -1, np.int64)
    ap[:E] = a
    bp[:E, 0] = b
    d = _cand_dist_dev(dev_vectors, dev_sq, jnp.asarray(ap),
                       jnp.asarray(bp), metric)
    return np.asarray(d)[:E, 0].astype(np.float64)


def _dev_row_dist(dev_vectors, dev_sq, anchors: np.ndarray,
                  others: np.ndarray, metric: str) -> np.ndarray:
    """dist(anchors[u], others[u, k]) -> [U, K] on device, U bucketed."""
    U, K = others.shape
    Up = bucket_pow2(max(U, 1), 256)
    ap = np.full(Up, -1, np.int64)
    op = np.full((Up, K), -1, np.int64)
    ap[:U] = anchors
    op[:U] = others
    d = _cand_dist_dev(dev_vectors, dev_sq, jnp.asarray(ap),
                       jnp.asarray(op), metric)
    return np.asarray(d)[:U].astype(np.float64)


def batch_reverse_insert(neigh_l: np.ndarray, vectors: np.ndarray,
                         sq: np.ndarray, tgt: np.ndarray, src: np.ndarray,
                         m: int, metric: str,
                         diversify: bool = True) -> None:
    """Vectorized reverse-edge application with worst-distance eviction.

    For every (tgt, src) pair, src enters tgt's neighbor row; when a row
    exceeds the degree cap ``m``, the farthest entries are evicted — the
    batched version of addNeighbor's eviction rule (graph.go:41-81),
    minus the evictee replenish (bulk-build deviation, see module
    docstring). ``m`` is the LAYER's degree cap and may be smaller than
    the physical row width. ``vectors``/``sq`` are DEVICE arrays; all
    distance math runs on the device, only grouping stays on host.
    """
    if len(tgt) == 0:
        return
    big = float(INF_DIST) / 2
    d = _dev_pair_dist(vectors, sq, tgt, src, metric)
    # Rank incoming edges within each target; keep the best m per target.
    order = np.lexsort((d, tgt))
    tgt_s, src_s, d_s = tgt[order], src[order], d[order]
    new_grp = np.r_[True, tgt_s[1:] != tgt_s[:-1]]
    grp_id = np.cumsum(new_grp) - 1
    grp_start = np.flatnonzero(new_grp)
    rank = np.arange(len(tgt_s)) - grp_start[grp_id]
    keep = rank < m
    tgt_s, src_s, d_s, grp_id, rank = (tgt_s[keep], src_s[keep], d_s[keep],
                                       grp_id[keep], rank[keep])
    uniq = tgt_s[np.r_[True, tgt_s[1:] != tgt_s[:-1]]]
    U = len(uniq)
    inc = np.full((U, m), -1, np.int64)
    inc_d = np.full((U, m), np.inf, np.float64)
    inc[grp_id, rank] = src_s
    inc_d[grp_id, rank] = d_s

    existing = neigh_l[uniq].astype(np.int64)          # [U, row_w]
    ex_d = _dev_row_dist(vectors, sq, uniq, existing, metric)
    # Dedup: drop incoming that already sit in the row.
    dup = (inc[:, :, None] == existing[:, None, :]).any(-1) & (inc >= 0)
    inc_d = np.where(dup, np.inf, inc_d)

    comb = np.concatenate([existing, inc], axis=1)      # [U, row_w + m]
    comb_d = np.concatenate([ex_d, inc_d], axis=1)
    row_w = neigh_l.shape[1]
    out = np.full((U, row_w), -1, np.int64)
    if diversify:
        # Heuristic re-selection on overflow (hnswlib applies the same
        # rule in mutuallyConnectNewElement); chunked to bound the
        # [chunk, C, C] device block.
        C = comb.shape[1]
        chunk = 8192
        for c0 in range(0, U, chunk):
            c1 = min(c0 + chunk, U)
            Pp = bucket_pow2(c1 - c0, 256)
            ci_p = np.full((Pp, C), -1, np.int64)
            cd_p = np.full((Pp, C), np.float32(INF_DIST), np.float32)
            ci_p[: c1 - c0] = comb[c0:c1]
            cd_p[: c1 - c0] = np.minimum(comb_d[c0:c1],
                                         float(INF_DIST)).astype(np.float32)
            rows = np.asarray(_diverse_select_dev(
                jnp.asarray(ci_p, jnp.int32), jnp.asarray(cd_p),
                vectors, sq, deg=m, metric=metric,
                diversify=True))[: c1 - c0].astype(np.int64)
            out[c0:c1, :m] = rows
    else:
        part = np.argpartition(comb_d, m - 1, axis=1)[:, :m]
        rows = np.take_along_axis(comb, part, axis=1)
        rows_d = np.take_along_axis(comb_d, part, axis=1)
        out[:, :m] = np.where(rows_d < big, rows, -1)
    neigh_l[uniq] = out.astype(np.int32)


def bulk_insert(host: host_build.HostGraph, slots: np.ndarray, *,
                wave: int = 1024, intra_k: Optional[int] = None) -> None:
    """Insert ``slots`` (already in the vector store) into the host graph
    by device-batched waves. Mutates host arrays in place."""
    cfg = host.cfg
    metric = host.metric
    m = cfg.m
    intra_k = intra_k if intra_k is not None else cfg.m_base
    store = host.store

    slots = np.asarray(slots, np.int64)
    n_new = len(slots)
    if n_new == 0:
        return
    # Levels sampled at each node's sequential position (graph.go:400:
    # cap depends on the CURRENT base-layer size).
    base = host.count
    levels = np.empty(n_new, np.int32)
    for i in range(n_new):
        cap_lvl = host_build.max_level(cfg.ml, base + i)
        lvl = 0
        while lvl < cap_lvl and host.rng.random() <= cfg.ml:
            lvl += 1
        levels[i] = lvl

    start = 0
    if host.entry < 0:  # bootstrap
        host._ensure(int(slots[0]), int(levels[0]))
        host.levels[slots[0]] = levels[0]
        host.count += 1
        host.entry, host.top = int(slots[0]), int(levels[0])
        start = 1

    max_cap = int(slots.max()) + 1 if n_new else 0
    host._ensure(max_cap - 1, int(levels.max()) if n_new else 0)
    ncap = host.neighbors.shape[1]
    store.ensure_capacity(ncap)
    vectors_all = store.vectors[:ncap]
    sq_all = store.sq_norms[:ncap]

    # Stable shapes across waves: always upload ALL layers (empty upper
    # layers are inert: the entry's row there is all -1, so beams stay
    # put) and pad the last wave's query count — one compile per build.
    L_all = host.neighbors.shape[0]
    n_cand = min(cfg.ef_construction, 2 * cfg.m_base)
    big = float(INF_DIST) / 2

    # Wave-size ramp: a wave never exceeds the current graph size, so
    # early nodes are inserted against a meaningful snapshot instead of
    # forming one giant intra-wave kNN blob. Pow2 sizes bound compiles.
    w0 = start
    while w0 < n_new:
        cur_wave = min(wave, max(256, bucket_pow2(host.count)))
        w1 = min(w0 + cur_wave, n_new)
        wslots = slots[w0:w1]
        wlevels = levels[w0:w1]
        W = len(wslots)
        snap_top = host.top

        # --- device: batched descent over the snapshot ------------------
        # only nodes inserted so far are searchable
        inserted = host.levels[:ncap] >= 0
        dev = from_host(vectors_all, sq_all, host.neighbors,
                        host.levels[:ncap], inserted, host.entry,
                        cap_pad=bucket_pow2(ncap))
        wvecs = vectors_all[wslots]
        wq = wvecs
        if W < cur_wave:  # pad to keep construction_descent's shape stable
            wq = np.concatenate(
                [wvecs,
                 np.broadcast_to(wvecs[-1:], (cur_wave - W, wvecs.shape[1]))])
        # fetch a wider candidate slate than the degree so the diversity
        # heuristic has material to choose from
        cand_d, cand_i = construction_descent(
            dev, jnp.asarray(wq), ef=max(cfg.ef_construction, n_cand),
            m_out=n_cand, metric=metric, max_hops=cfg.max_hops)
        cand_d = np.asarray(cand_d)[:, :W]   # [L_all, W, n_cand]
        cand_i = np.asarray(cand_i)[:, :W]

        # --- intra-wave candidates (one W x W distance block, on device) --
        intra_d = np.asarray(pairwise_dist(
            jnp.asarray(wq), jnp.asarray(wq),
            metric=metric))[:W, :W].astype(np.float64)
        np.fill_diagonal(intra_d, np.inf)

        max_l = int(max(wlevels.max(initial=0), snap_top))
        C_max = n_cand + intra_k            # fixed candidate width
        rev_t: List[np.ndarray] = []
        rev_s: List[np.ndarray] = []
        rev_layers: List[int] = []
        for layer in range(0, max_l + 1):
            part = np.flatnonzero(wlevels >= layer)
            if len(part) == 0:
                continue
            deg = cfg.max_degree(layer)
            P = len(part)
            comb_i = np.full((P, C_max), -1, np.int64)
            comb_d = np.full((P, C_max), np.inf)
            # snapshot candidates at this layer
            sc_i = cand_i[layer][part].astype(np.int64)       # [P, n_cand]
            sc_d = cand_d[layer][part].astype(np.float64)
            sc_d = np.where(sc_i >= 0, sc_d, np.inf)
            comb_i[:, :n_cand] = sc_i
            comb_d[:, :n_cand] = sc_d
            # intra-wave candidates at this layer
            in_layer = wlevels >= layer
            iw = intra_d[np.ix_(part, np.flatnonzero(in_layer))]
            iw_slots = wslots[in_layer]
            kk = min(intra_k, iw.shape[1])
            if kk > 0:
                sel = np.argpartition(iw, kk - 1, axis=1)[:, :kk]
                iw_d = np.take_along_axis(iw, sel, axis=1)
                iw_i = np.where(np.isfinite(iw_d), iw_slots[sel], -1)
                comb_i[:, n_cand:n_cand + kk] = iw_i
                comb_d[:, n_cand:n_cand + kk] = iw_d

            # device heuristic selection, P bucketed for compile reuse
            Pp = bucket_pow2(P, 64)
            ci_p = np.full((Pp, C_max), -1, np.int64)
            cd_p = np.full((Pp, C_max), np.float32(INF_DIST), np.float32)
            ci_p[:P] = comb_i
            cd_p[:P] = np.minimum(comb_d, float(INF_DIST)).astype(np.float32)
            row_i = np.asarray(_diverse_select_dev(
                jnp.asarray(ci_p, jnp.int32), jnp.asarray(cd_p),
                dev.vectors, dev.sq_norms, deg=deg, metric=metric,
                diversify=cfg.diversify))[:P].astype(np.int64)
            # set wave rows (-1 padded to the m_base row width)
            rows = np.full((P, host.neighbors.shape[2]), -1, np.int32)
            rows[:, :deg] = row_i.astype(np.int32)
            host.neighbors[layer][wslots[part]] = rows
            # collect reverse edges
            e_mask = row_i >= 0
            rev_t.append(row_i[e_mask])
            rev_s.append(np.repeat(wslots[part], e_mask.sum(axis=1)))
            rev_layers.append(layer)

        # --- reverse edges with eviction, grouped per layer ---------------
        for layer, t, s in zip(rev_layers, rev_t, rev_s):
            batch_reverse_insert(host.neighbors[layer], dev.vectors,
                                 dev.sq_norms, t, s,
                                 cfg.max_degree(layer), metric,
                                 diversify=cfg.diversify)

        # --- commit wave --------------------------------------------------
        host.levels[wslots] = wlevels
        host.count += W
        wmax = int(wlevels.max())
        if wmax > host.top:
            host.top = wmax
            host.entry = int(wslots[int(np.argmax(wlevels))])
        w0 = w1
