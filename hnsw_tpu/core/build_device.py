"""Device-resident bulk construction.

core/build.py's wave builder keeps the neighbor tables host-authoritative
and re-uploads them every wave — fine on CPU, but every wave then pays a
full table transfer each way. This module keeps ALL build state on
device across waves:

  vectors/sq     uploaded once (immutable during build)
  neighbors      device-resident [L, cap, W], updated by scatters
  levels/alive   device-resident, scatter-committed per wave

Per wave the only host<->device traffic is the wave's slot ids and
levels (KBs). Edge assembly runs fully on device:

  * wave rows: candidate slate (descent pool + intra-wave top-k) ->
    diversity-heuristic selection (_diverse_select_dev) -> row scatter;
  * reverse edges: sort-based dense segmentation — rank incoming edges
    per target with an argsort + cummax trick, scatter the best m into
    a [cap, m] incoming buffer, then one dense masked top-m merge of
    (existing row ∪ incoming) per target (plain closest-m by default —
    the measured recall delta vs heuristic re-selection is nil at 10k;
    GraphConfig.reverse_diversify switches to the diversity heuristic).

The host arrays are synchronized ONCE at the end (single D2H).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnsw_tpu.config import canonical_metric
from hnsw_tpu.core import host_build
from hnsw_tpu.utils.transfer import chunked_put
from hnsw_tpu.core.build import (_diverse_select_dev, construction_descent)
from hnsw_tpu.core.state import DeviceGraph, bucket_pow2
from hnsw_tpu.ops.distance import INF_DIST, pairwise_dist
from hnsw_tpu.ops.pallas_exact import scan_topk


@functools.partial(jax.jit, static_argnames=("metric",))
def _row_dist_dense(vectors, sq, anchors, others, metric):
    """dist(vectors[anchors[u]], vectors[others[u,k]]) -> [U, K];
    -1 anchors/others give INF."""
    safe_a = jnp.clip(anchors, 0, vectors.shape[0] - 1)
    safe_o = jnp.clip(others, 0, vectors.shape[0] - 1)
    va = vectors[safe_a].astype(jnp.float32)
    vo = vectors[safe_o].astype(jnp.float32)
    from hnsw_tpu.ops.distance import _custom_pairwise_jax, registered
    spec = registered(metric)
    if spec is not None:
        pw = _custom_pairwise_jax(metric, spec)
        d = jax.vmap(lambda a, o: pw(a[None, :], o)[0])(va, vo)
        return jnp.where((others >= 0) & (anchors[:, None] >= 0), d,
                         INF_DIST)
    # HIGHEST: these distances rank edge selection; at DEFAULT a GPU
    # would run them as TF32
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


@functools.partial(
    jax.jit,
    static_argnames=("deg", "n_cand", "metric", "diversify"))
def _assemble_refine_rows(vectors, sq, cand_d_l, cand_i_l, wslots,
                          part_idx, *, deg, n_cand, metric, diversify):
    """Refinement rows: snapshot candidates only, self-excluded.

    Candidate distances are RE-SCORED in f32 (_row_dist_dense) rather
    than trusting the descent pool's values — the descent may run over
    the int8 or fp16 store, so its distances order the pool but should
    not rank edge selection."""
    W = wslots.shape[0]
    safe_p = jnp.clip(part_idx, 0, W - 1)
    sc_i = cand_i_l[safe_p].astype(jnp.int32)
    self_slot = wslots[safe_p][:, None]
    anchors = jnp.where(part_idx >= 0, wslots[safe_p].astype(jnp.int32), -1)
    sc_d = _row_dist_dense(vectors, sq, anchors, sc_i, metric)
    sc_d = jnp.where((sc_i >= 0) & (sc_i != self_slot), sc_d, INF_DIST)
    rows = _diverse_select_dev(sc_i, sc_d, vectors, sq, deg=deg,
                               metric=metric, diversify=diversify)
    return jnp.where((part_idx >= 0)[:, None], rows, -1)


@functools.partial(
    jax.jit,
    static_argnames=("deg", "n_cand", "intra_k", "metric", "diversify"))
def _assemble_wave_rows(vectors, sq, cand_d_l, cand_i_l, intra_d,
                        wslots, part_idx, in_layer, *, deg, n_cand,
                        intra_k, metric, diversify):
    """Wave-node rows for one layer, fully on device.

    cand_d_l/cand_i_l: [W, n_cand] snapshot candidates at this layer
    intra_d:           [W, W] intra-wave distances (diag INF)
    wslots:            [W] global slot per wave node
    part_idx:          [Pp] indices into the wave (-1 pad) participating
    in_layer:          [W] bool — wave nodes whose level >= layer
    Returns rows [Pp, deg] of global slots (-1 pad).
    """
    W = intra_d.shape[0]
    safe_p = jnp.clip(part_idx, 0, W - 1)
    sc_i = cand_i_l[safe_p].astype(jnp.int32)          # [Pp, n_cand]
    # f32 rescore (see _assemble_refine_rows): the descent's pool
    # distances are approximate (bf16 / int8 store); edge selection
    # ranks on exact distances.
    anchors = jnp.where(part_idx >= 0, wslots[safe_p].astype(jnp.int32), -1)
    sc_d = _row_dist_dense(vectors, sq, anchors, sc_i, metric)
    sc_d = jnp.where(sc_i >= 0, sc_d, INF_DIST)
    iw = intra_d[safe_p]                                # [Pp, W]
    iw = jnp.where(in_layer[None, :], iw, INF_DIST)
    kk = min(intra_k, W)
    neg, cols = jax.lax.top_k(-iw, kk)                  # [Pp, kk]
    iw_d = -neg
    iw_i = jnp.where(iw_d < INF_DIST, wslots[cols].astype(jnp.int32), -1)
    comb_i = jnp.concatenate([sc_i, iw_i], axis=1)
    comb_d = jnp.concatenate([sc_d, iw_d], axis=1).astype(jnp.float32)
    rows = _diverse_select_dev(comb_i, comb_d, vectors, sq, deg=deg,
                               metric=metric, diversify=diversify)
    return jnp.where((part_idx >= 0)[:, None], rows, -1)


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(nb_l, tgt_rows, rows):
    """In-place row scatter into a neighbor table (donated).

    ``tgt_rows`` >= nb_l.shape[0] are dropped (``mode="drop"``), so
    callers flag skipped rows by pointing them past the table instead
    of concatenating a sacrificial row. The eager
    concat -> scatter -> slice chain this replaces materialized up to
    three extra copies of the table per layer update — 6+ GB of
    transients on a 2.1 GB 16M layer-0 table, which OOMed the 16M
    single-chip build at its first wave. Donation aliases input and
    output so the update is a true in-place scatter."""
    return nb_l.at[tgt_rows].set(rows, mode="drop")


@functools.partial(jax.jit, static_argnames=("deg", "metric", "diversify"),
                   donate_argnums=(0,))
def _reverse_update(nb_l, vectors, sq, tgt, src, *, deg, metric,
                    diversify=False, row_of=None):
    """Apply reverse edges (tgt <- src) to one layer's neighbor table.

    nb_l: [rows_n, Wd] int32; tgt/src: [E] int32 SLOT ids (-1 pads
    skipped). Per target keeps the closest ``deg`` of (existing ∪
    incoming) — or, with ``diversify``, re-selects the row with the
    Malkov neighbor-diversity heuristic (_diverse_select_dev), matching
    the forward-edge selection. Closest-deg is the measured-equal
    default (no recall delta at 10k; the heuristic costs an extra
    [A, C, C] candidate-pairwise gram per chunk).

    ``row_of`` ([cap] int32, optional) maps slot -> table row for the
    COMPACT upper-layer layout (DeviceGraph.upper_map): distances are
    computed in slot space, reads/writes of nb_l go through the map.
    None means rows are indexed by slot (layer 0 / dense tables).

    Work scales with the EDGE count, not cap: touched targets are
    compacted (<= E of them) and re-selected in bounded chunks — a dense
    per-row pass materialized [cap, Wd+deg, D] gathers, which is 34 GB
    at cap=1M and OOMed the 1M build.
    """
    rows_n, Wd = nb_l.shape
    slot_hi = vectors.shape[0]                          # cap_pad
    E = tgt.shape[0]
    # rank incoming edges within each target: sort by (tgt, dist)
    d = _row_dist_dense(vectors, sq, tgt, src[:, None], metric)[:, 0]
    tgt_valid = tgt >= 0
    key_t = jnp.where(tgt_valid, tgt, slot_hi)          # pads last
    order = jnp.lexsort((d, key_t))
    t_s = key_t[order]
    s_s = src[order]
    d_s = d[order]
    idx = jnp.arange(E, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), t_s[1:] != t_s[:-1]])
    start_idx = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, idx, 0))
    rank = idx - start_idx
    m_in = deg
    keep = (t_s < slot_hi) & (rank < m_in) & (d_s < INF_DIST)

    def to_row(slots_arr):
        if row_of is None:
            return slots_arr
        return row_of[jnp.clip(slots_arr, 0, slot_hi - 1)]

    # scatter incoming into [rows_n, m_in] buffer (drop out-of-range)
    r_ix = to_row(t_s)
    row_ix = jnp.where(keep & (r_ix >= 0), r_ix, rows_n)
    col_ix = jnp.clip(rank, 0, m_in - 1)
    inc = jnp.full((rows_n + 1, m_in), -1, jnp.int32)
    inc = inc.at[row_ix, col_ix].set(jnp.where(keep, s_s, -1), mode="drop")
    inc = inc[:rows_n]

    # compact unique touched target SLOTS (<= E), pads sort to the tail
    uniq = jnp.sort(jnp.where(is_start & (t_s < slot_hi), t_s, slot_hi))
    chunk = min(4096, E)
    n_chunks = -(-E // chunk)
    pad_e = n_chunks * chunk - E
    if pad_e:
        uniq = jnp.pad(uniq, (0, pad_e), constant_values=slot_hi)

    def step(nb_l, anchors):
        arow = to_row(anchors)
        valid = (anchors < slot_hi) & (arow >= 0)
        safe = jnp.clip(arow, 0, rows_n - 1)
        rows_nb = nb_l[safe]                            # [A, Wd]
        rows_inc = inc[safe]                            # [A, m_in]
        comb = jnp.concatenate([rows_nb, rows_inc], axis=1)
        anc = jnp.where(valid, anchors, -1)
        comb_d = _row_dist_dense(vectors, sq, anc, comb, metric)
        # dedup incoming already present in the row
        dup = ((rows_inc[:, :, None] == rows_nb[:, None, :]).any(-1)
               & (rows_inc >= 0))
        comb_d = comb_d.at[:, Wd:].set(
            jnp.where(dup, INF_DIST, comb_d[:, Wd:]))
        if diversify:
            new_rows = _diverse_select_dev(comb, comb_d, vectors, sq,
                                           deg=deg, metric=metric,
                                           diversify=True)
        else:
            negv, pos = jax.lax.top_k(-comb_d, deg)
            new_rows = jnp.where(-negv < INF_DIST,
                                 jnp.take_along_axis(comb, pos, axis=1),
                                 -1)
        if Wd > deg:
            new_rows = jnp.concatenate(
                [new_rows, jnp.full((anchors.shape[0], Wd - deg), -1,
                                    jnp.int32)], axis=1)
        write = jnp.where(valid, arow, rows_n)          # OOB -> dropped
        nb_l = nb_l.at[write].set(new_rows, mode="drop")
        return nb_l, None

    nb_l, _ = jax.lax.scan(step, nb_l, uniq.reshape(n_chunks, chunk))
    return nb_l


def _sparse_sync(host: host_build.HostGraph, nb0_dev, nbU_tabs,
                 ups: np.ndarray, u_counts, ncap: int) -> None:
    """D2H of the final neighbor state: dense layer 0, occupied uppers.

    Only a ml^l fraction of nodes reaches layer l, so a dense pull of
    an upper stack ships ~10x the occupied bytes. With the COMPACT
    level-ranked layout the occupied rows of
    layer l are exactly the table prefix [0, U_l): the sync is one
    contiguous slice pull per layer, no gather at all.

    ``nb0_dev`` [cap_pad, Wd] is layer 0; ``nbU_tabs`` is the jagged
    tuple of [U_l_pad, m] upper tables (None when the graph has one
    layer); ``ups`` maps compact rank -> slot; ``u_counts[l-1]`` is the
    occupancy of layer l.
    """
    L_all = host.neighbors.shape[0]
    from hnsw_tpu.utils.transfer import chunked_get
    chunked_get(nb0_dev[:ncap], out=host.neighbors[0])
    for l in range(1, L_all):
        host.neighbors[l][:ncap] = -1
        u_l = u_counts[l - 1] if nbU_tabs is not None else 0
        if not u_l:
            continue
        # bounded D2H: layer 1 at 16M nodes is a ~270 MB occupied prefix
        sel = chunked_get(nbU_tabs[l - 1][:u_l])         # [U_l, m_up]
        rows = ups[:u_l]
        m_up = sel.shape[1]
        host.neighbors[l][rows, :m_up] = sel
        host.neighbors[l][rows, m_up:] = -1


def _compact_upper_tables(host: host_build.HostGraph, lv_all: np.ndarray,
                          cap_pad: int, L_all: int, m_up: int):
    """Build the COMPACT jagged upper tables (DeviceGraph.nbr_upper /
    upper_map) from final node levels: upper nodes ranked by DESCENDING
    level so layer l occupies the prefix [0, U_l) of its right-sized
    table. Returns (ups, u_counts, nbU_tabs, umap_dev); tabs/map are
    None for single-layer graphs."""
    ups = np.flatnonzero(lv_all >= 1)
    ups = ups[np.argsort(-lv_all[ups], kind="stable")]
    umap = np.full(cap_pad, -1, np.int32)
    umap[ups] = np.arange(len(ups), dtype=np.int32)
    u_counts = [int((lv_all >= l).sum()) for l in range(1, L_all)]
    nbU_tabs = umap_dev = None
    if L_all > 1:
        nbU_tabs = []
        for lyr in range(1, L_all):
            u_l = u_counts[lyr - 1]
            # chunked H2D with device-side -1 fill (new slots stay -1):
            # the padding is never staged on the host
            occ = (np.ascontiguousarray(
                       host.neighbors[lyr][ups[:u_l], :m_up])
                   if u_l else np.zeros((0, m_up), np.int32))
            nbU_tabs.append(chunked_put(
                occ, -1, shape=(bucket_pow2(max(u_l, 1), 8), m_up)))
        umap_dev = jnp.asarray(umap)
    return ups, u_counts, nbU_tabs, umap_dev


class BuildDeadlineExceeded(RuntimeError):
    """A deadline-bounded build stopped early AFTER saving a resumable
    checkpoint. The graph is partially built (pending nodes have
    level < 0); finish it with ``Graph.resume_build(checkpoint_path)``.

    Lets a multi-hour build leave the device by a hard wall-clock
    deadline with a resumable checkpoint and a servable prefix, instead
    of being killed and losing the work since the last checkpoint.
    """


def bulk_insert_device(host: host_build.HostGraph, slots: np.ndarray, *,
                       wave: int = 2048,
                       intra_k: Optional[int] = None,
                       quant_descent: bool = False,
                       block_m: Optional[int] = None,
                       descent_dtype: str = "float32",
                       on_checkpoint=None,
                       checkpoint_every: int = 0,
                       abort_deadline: Optional[float] = None) -> None:
    """Device-resident wave insertion; syncs host arrays once at the end.

    ``quant_descent`` gives the construction descent the int8
    neighbor-BLOCK layout: per wave, layer-0 blocks are rebuilt by one
    device gather from a globally-scaled int8 copy of the store, so each
    descent hop gathers one contiguous [M0, D] block per expanded node
    instead of M0 scattered rows (row gathers are bound by the number of
    rows, not their bytes). Edge SELECTION still scores raw-f32
    at HIGHEST precision (_diverse_select_dev / _reverse_update), so
    only the candidate pool ordering sees quantization noise.

    ``on_checkpoint(inserted)`` + ``checkpoint_every=K`` snapshot the
    build every K waves: device levels/neighbors sync to the host
    arrays, then the callback persists them (Graph.build wires it to
    io.codec.save_graph). A killed 8M build loses at most K waves
    instead of hours (Graph.resume_build restarts it).

    ``abort_deadline`` (absolute ``time.time()`` seconds) stops the
    build gracefully at the first wave boundary past the deadline:
    sync host arrays, write a checkpoint (if wired), then raise
    BuildDeadlineExceeded, so the process exits cleanly with its work
    saved.

    ``descent_dtype="float16"`` uploads the HBM vector table as fp16 —
    half the table bytes AND half the row-gather bytes of the descent
    (gathers are row-granularity-bound), with enough mantissa to rank
    tightly clustered data where int8 fails. Every scoring op casts to
    f32 on-chip and the fp16 gather path forces Precision.HIGHEST
    (core/search._score_hop; DEFAULT and HIGH would run f32 operands as
    TF32 on a GPU, 10 significand bits against fp16's 11), so only the
    one-time fp16 rounding of
    the stored components is lost (a 16.8M x 128 f32 table alone is
    8.6 GB).
    """
    cfg = host.cfg
    metric = canonical_metric(host.metric)
    intra_k = intra_k if intra_k is not None else cfg.m_base
    store = host.store
    # the intra-wave kNN is a dense [W, W] f32 matrix (+ a same-size
    # gather in _assemble_wave_rows): 4.3 GB each at W=32768. 16384
    # (1 GB) was set for a 16 GB device.
    if wave > 16384:
        import warnings
        warnings.warn(f"wave={wave} clamped to 16384 (intra-wave kNN "
                      f"is O(W^2) HBM)", RuntimeWarning)
        wave = 16384

    slots = np.asarray(slots, np.int64)
    n_new = len(slots)
    if n_new == 0:
        return
    # Level sampling, vectorized. The sequential law (host path /
    # graph.go:370-417) is `while lvl < cap and rng() <= ml: lvl += 1`,
    # i.e. P(lvl >= k) = ml^k capped at max_level of the graph size at
    # insertion time; floor(log u / log ml) for one uniform u has
    # exactly that tail (u <= ml^k <=> the ratio >= k), so ONE
    # rng.random(n) draw replaces the per-node Python loop — which at
    # 8M inserts is minutes of interpreter time on a slow host core.
    # (Consumes a different rng stream count than the sequential loop:
    # same-seed builds differ from pre-vectorization builds, same law.)
    counts = host.count + np.arange(n_new, dtype=np.int64)
    inv = math.log(1.0 / cfg.ml)
    cap_lvl = np.where(
        counts == 0, 1,
        np.round(np.log(np.maximum(counts, 1)) / inv).astype(np.int64) + 1)
    u = np.maximum(host.rng.random(n_new), 1e-300)
    geom = np.floor(np.log(u) / math.log(cfg.ml)).astype(np.int64)
    levels = np.minimum(geom, cap_lvl).astype(np.int32)

    start = 0
    if host.entry < 0:
        host._ensure(int(slots[0]), int(levels[0]))
        host.levels[slots[0]] = levels[0]
        host.count += 1
        host.entry, host.top = int(slots[0]), int(levels[0])
        start = 1

    host._ensure(int(slots.max()), int(levels.max()))
    ncap = host.neighbors.shape[1]
    store.ensure_capacity(ncap)
    cap_pad = bucket_pow2(ncap)
    L_all = host.neighbors.shape[0]
    Wd = host.neighbors.shape[2]

    # ---- one-time uploads -------------------------------------------------
    def pad_rows(a, fill, shape):
        if a.shape == shape:
            return a          # pow2-exact capacity: skip a GB-scale copy
        out = np.full(shape, fill, a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    vectors_dev = chunked_put(
        store.vectors[:ncap], 0, shape=(cap_pad, store.dim),
        dtype=np.float16 if descent_dtype == "float16" else np.float32)
    sq_dev = jnp.asarray(pad_rows(store.sq_norms[:ncap], 0, (cap_pad,)))
    # COMPACT upper storage (DeviceGraph.nbr_upper): layer 0 at the
    # full degree; uppers as jagged per-layer tables indexed by
    # level-DESCENDING rank, so layer l's nodes occupy the prefix
    # [0, U_l) of every table. Every node's final level is known here
    # (existing graph + the freshly sampled wave levels), so the whole
    # assignment is static for the build: ~N/3 upper rows total instead
    # of (L-1) * cap — the 8M+ single-chip enabler (the dense split
    # stack before it was 5.9 GB at 8M; the [L, cap, Wd] stack before
    # THAT was the 4M blocker).
    m_up = cfg.m
    nb0_dev = chunked_put(host.neighbors[0], -1, shape=(cap_pad, Wd))
    lv_all = np.full(cap_pad, -1, np.int32)
    lv_all[:ncap] = host.levels[:ncap]
    lv_all[slots] = levels
    ups, u_counts, nbU_tabs, umap_dev = _compact_upper_tables(
        host, lv_all, cap_pad, L_all, m_up)
    levels_dev = jnp.asarray(pad_rows(host.levels[:ncap], -1, (cap_pad,)))
    alive_dev = levels_dev >= 0
    qvec_dev = qscale_dev = block_scale = None
    from hnsw_tpu.ops.distance import registered
    if quant_descent and registered(metric) is None:
        gs = float(np.abs(store.vectors[:ncap]).max()) / 127.0 or 1.0
        qh = np.clip(np.rint(store.vectors[:ncap] / gs),
                     -127, 127).astype(np.int8)
        qvec_dev = chunked_put(qh, 0, shape=(cap_pad, store.dim))
        qscale_dev = jnp.asarray(np.full((cap_pad,), gs, np.float32))
        block_scale = jnp.asarray(np.float32(gs))
        if block_m is None and cap_pad * Wd * store.dim > 5 * 1024 ** 3:
            # HBM guard, set for a 16 GB device: full blocks would not
            # leave room for the descent working set (2M+ builds; at 4M
            # even half rows are 2 GB of int8 blocks)
            block_m = max(8, Wd // 2)
            if cap_pad * block_m * store.dim > 5 * 1024 ** 3:
                block_m = 8

    n_cand = min(cfg.ef_construction, 2 * cfg.m_base)
    import time as _time

    from hnsw_tpu.utils.progress import BuildHeartbeat
    _hb = BuildHeartbeat(n_new, "device build")
    _waves_done = 0
    w0 = start
    while w0 < n_new:
        # ramp: a wave may be up to 4x the current graph size (the
        # intra-wave kNN carries within-wave edges; refine() recovers
        # any residual early-wave quality). Fewer ramp steps = fewer
        # compiled shapes = faster builds on remote-compile backends.
        cur_wave = min(wave, max(512, bucket_pow2(4 * host.count)))
        w1 = min(w0 + cur_wave, n_new)
        wslots = slots[w0:w1]
        wlevels = levels[w0:w1]
        W = len(wslots)

        wslots_pad = np.full(cur_wave, -1, np.int64)
        wslots_pad[:W] = wslots
        wsl_dev = jnp.asarray(np.where(wslots_pad >= 0, wslots_pad, 0)
                              .astype(np.int32))
        nbr_blocks = None
        if qvec_dev is not None:
            from hnsw_tpu.core.state import _gather_blocks
            # drop the PREVIOUS wave's DeviceGraph (it pins the old
            # block tensor) before gathering the new one — at 2M+ two
            # live block tensors alone would exceed HBM
            g = None  # noqa: F841
            nbr_blocks = _gather_blocks(qvec_dev, nb0_dev,
                                        block_m=block_m)
        g = DeviceGraph(vectors=vectors_dev, sq_norms=sq_dev,
                        neighbors=nb0_dev[None], levels=levels_dev,
                        alive=alive_dev,
                        entry=jnp.asarray(np.int32(host.entry)),
                        qvec=qvec_dev, qscale=qscale_dev,
                        nbr_blocks=nbr_blocks, block_scale=block_scale,
                        nbr_upper=(tuple(nbU_tabs) if nbU_tabs is not None
                                   else None),
                        upper_map=umap_dev)
        wq = vectors_dev[wsl_dev]
        cand_d, cand_i = construction_descent(
            g, wq, ef=max(cfg.ef_construction, n_cand), m_out=n_cand,
            metric=metric, max_hops=cfg.max_hops)       # [L_all, cw, n_cand]
        # layer 0 takes the EXACT top-n_cand of the inserted snapshot in
        # place of the descent's pool: on data of many small, far-apart
        # clusters the descent cannot route between clusters, lands in
        # the wrong one, and links new nodes across clusters
        ex_d, ex_i = scan_topk(wq, vectors_dev, sq_dev, alive_dev,
                               k=n_cand, metric=metric)
        cand_d = cand_d.at[0].set(ex_d)
        cand_i = cand_i.at[0].set(ex_i)

        # HIGHEST so intra-wave distances rank consistently against the
        # f32-rescored snapshot candidates in _assemble_wave_rows
        intra = pairwise_dist(wq, wq, metric=metric,
                              precision=jax.lax.Precision.HIGHEST)
        eye = jnp.arange(cur_wave)
        intra = intra.at[eye, eye].set(INF_DIST)
        # padded rows must not act as candidates
        wpad_mask = jnp.asarray(wslots_pad >= 0)
        intra = jnp.where(wpad_mask[None, :], intra, INF_DIST)
        # the DeviceGraph's neighbors=nb0_dev[None] is an eager reshape
        # COPY of the full layer-0 table (2.1 GB at 16M); it is only
        # needed by the descent above — release it before the layer
        # updates so their donated scatters have headroom
        g = None  # noqa: F841

        max_l = int(max(wlevels.max(initial=0), host.top))
        for layer in range(0, min(max_l, L_all - 1) + 1):
            part = np.flatnonzero(wlevels >= layer)
            if len(part) == 0:
                continue
            deg = cfg.max_degree(layer)
            # constant shape per (wave, deg): compile twice per wave
            # size, not once per participant-count bucket
            Pp = cur_wave
            part_pad = np.full(Pp, -1, np.int64)
            part_pad[:len(part)] = part
            in_layer = np.zeros(cur_wave, bool)
            in_layer[:W] = wlevels >= layer

            rows = _assemble_wave_rows(
                vectors_dev, sq_dev, cand_d[layer], cand_i[layer], intra,
                wsl_dev, jnp.asarray(part_pad.astype(np.int32)),
                jnp.asarray(in_layer), deg=deg, n_cand=n_cand,
                intra_k=intra_k, metric=metric,
                diversify=cfg.diversify)                # [Pp, deg]

            # scatter wave rows (layer 0 and uppers live in separate
            # tables at their own widths; deg == table width for both).
            # Upper writes go through the compact slot->row map.
            tgt_slots = jnp.where(jnp.asarray(part_pad) >= 0,
                                  wsl_dev[jnp.clip(jnp.asarray(
                                      part_pad.astype(np.int32)), 0,
                                      cur_wave - 1)],
                                  cap_pad)  # dropped
            Wl = Wd if layer == 0 else m_up
            full_rows = jnp.concatenate(
                [rows, jnp.full((Pp, Wl - deg), -1, jnp.int32)], axis=1) \
                if Wl > deg else rows
            if layer == 0:
                nb_l = nb0_dev
                rows_n = cap_pad
                tgt_rows = tgt_slots
            else:
                nb_l = nbU_tabs[layer - 1]
                rows_n = nb_l.shape[0]
                tr = umap_dev[jnp.clip(tgt_slots, 0, cap_pad - 1)]
                tgt_rows = jnp.where((tgt_slots < cap_pad) & (tr >= 0),
                                     tr, rows_n)
            if layer == 0:
                nb0_dev = None  # release: nb_l's buffer is donated next
            else:
                nbU_tabs[layer - 1] = None
            nb_l = _scatter_rows(nb_l, tgt_rows, full_rows)

            # reverse edges (slot-space pairs; _reverse_update remaps)
            rev_t = rows.reshape(-1)
            rev_s = jnp.repeat(tgt_slots.astype(jnp.int32), deg)
            rev_t = jnp.where((rev_t >= 0) & (rev_s < cap_pad), rev_t, -1)
            rev_s = jnp.where(rev_t >= 0, rev_s, -1)
            nb_l = _reverse_update(nb_l, vectors_dev, sq_dev, rev_t,
                                   rev_s, deg=deg, metric=metric,
                                   diversify=cfg.reverse_diversify,
                                   row_of=None if layer == 0 else umap_dev)
            if layer == 0:
                nb0_dev = nb_l
            else:
                nbU_tabs[layer - 1] = nb_l

        # commit wave (device scatters + host bookkeeping)
        upd = jnp.asarray(wslots.astype(np.int32))
        levels_dev = levels_dev.at[upd].set(
            jnp.asarray(wlevels.astype(np.int32)))
        alive_dev = alive_dev.at[upd].set(True)
        host.count += W
        wmax = int(wlevels.max())
        if wmax > host.top:
            host.top = wmax
            host.entry = int(wslots[int(np.argmax(wlevels))])
        w0 = w1
        _waves_done += 1
        if _hb.due():
            # sync before printing: the count must reflect COMPLETED
            # device work, or the heartbeat lies during long dispatch
            # pipelines exactly when an operator needs the truth
            jax.block_until_ready(nb0_dev)
            _hb.emit(w0, extra=f" [wave +{W}]")
        _deadline_hit = (abort_deadline is not None and w0 < n_new
                         and _time.time() >= abort_deadline)
        if _deadline_hit or (
                on_checkpoint is not None and checkpoint_every > 0
                and w0 < n_new and _waves_done % checkpoint_every == 0):
            # mid-build host sync: levels mark exactly the inserted
            # prefix (-1 = pending), neighbor pulls ride chunked_get;
            # the device tables stay the build's source of truth
            host.levels[:ncap] = np.asarray(levels_dev[:ncap])
            _sparse_sync(host, nb0_dev, nbU_tabs, ups, u_counts, ncap)
            if on_checkpoint is not None:
                on_checkpoint(int(w0))
                ck = getattr(on_checkpoint, "checkpoint_path", None)
                if ck:
                    _hb.checkpoint(ck)
                elif not _hb.silent:
                    _hb.emit(w0, extra=" [checkpoint synced]")
        if _deadline_hit:
            raise BuildDeadlineExceeded(
                f"build deadline reached after {w0}/{n_new} inserts; "
                f"host state synced"
                + (" and checkpoint saved" if on_checkpoint else "")
                + " — finish with Graph.resume_build")

    # ---- single D2H sync ----------------------------------------------------
    lv = np.asarray(levels_dev[:ncap])
    host.levels[:ncap] = lv
    _sparse_sync(host, nb0_dev, nbU_tabs, ups, u_counts, ncap)


def _local_repair_wave(g: DeviceGraph, nb0_dev, vectors, sq, wsl, valid,
                       *, deg, n_cand, metric, hops, ef, diversify,
                       reverse_diversify):
    """One local-repair wave: seeded short beam -> layer-0 row
    re-selection -> reverse update. See refine_device(local=True)."""
    from hnsw_tpu.core.search import beam_search_layer
    from hnsw_tpu.ops.distance import gathered_dist
    cap_pad = nb0_dev.shape[0]
    Wv = wsl.shape[0]
    wq = vectors[wsl]
    q_sq = jnp.sum(wq * wq, axis=-1)
    seeds = jnp.concatenate(
        [g.layer_neighbors(0)[wsl],
         jnp.broadcast_to(g.entry.astype(jnp.int32), (Wv,))[:, None]],
        axis=1)
    safe = jnp.clip(seeds, 0, g.cap - 1)
    sd = gathered_dist(wq, g.vectors[safe], g.sq_norms[safe], q_sq,
                       metric=metric,
                       precision=jax.lax.Precision.HIGHEST)
    sd = jnp.where((seeds >= 0) & (seeds != wsl[:, None]), sd, INF_DIST)
    pd, pi = beam_search_layer(g, 0, wq, q_sq, seeds, sd, pool_size=ef,
                               max_hops=hops, metric=metric,
                               precision=jax.lax.Precision.HIGHEST,
                               expand=4)
    part_idx = jnp.where(valid, jnp.arange(Wv, dtype=jnp.int32), -1)
    rows = _assemble_refine_rows(vectors, sq, pd[:, :n_cand],
                                 pi[:, :n_cand], wsl, part_idx,
                                 deg=deg, n_cand=n_cand, metric=metric,
                                 diversify=diversify)
    Wl = nb0_dev.shape[1]
    if Wl > deg:
        rows = jnp.concatenate(
            [rows, jnp.full((Wv, Wl - deg), -1, jnp.int32)], axis=1)
    tgt = jnp.where(valid, wsl, cap_pad).astype(jnp.int32)
    nb0 = _scatter_rows(nb0_dev, tgt, rows)
    rev_t = rows[:, :deg].reshape(-1)
    rev_s = jnp.repeat(tgt, deg)
    rev_t = jnp.where((rev_t >= 0) & (rev_s < cap_pad), rev_t, -1)
    rev_s = jnp.where(rev_t >= 0, rev_s, -1)
    return _reverse_update(nb0, vectors, sq, rev_t, rev_s, deg=deg,
                           metric=metric, diversify=reverse_diversify)


def refine_device(host: host_build.HostGraph, *, wave: int = 2048,
                  slots=None, quant_descent: bool = False,
                  block_m: Optional[int] = None, local: bool = False,
                  local_hops: int = 3) -> None:
    """Second-pass graph refinement.

    Re-runs the construction descent for every node against the FINAL
    graph and re-selects its edges (+ reverse edges). Wave construction
    gives early nodes edges chosen against small snapshots; one
    refinement pass re-chooses them with full information — the standard
    quality-recovery step for batched builders. Device-resident; host
    arrays synced once at the end.

    ``slots`` scopes the pass to a subset of nodes — the post-delete
    repair path (replenish alone leaves delete-heavy recall
    degraded; re-running the descent for the affected neighborhoods
    restores it, mirroring graph.go:172-219's quality intent).

    ``local=True`` is the CHEAP repair variant: instead of a full
    construction descent from the entry point, each node's candidates
    come from a ``local_hops``-hop layer-0 beam SEEDED with its current
    neighbors (+ the entry as a connectivity fallback), and only layer-0
    edges are re-selected (upper-layer rows were already repaired by
    replenish and re-selecting them from layer-0 candidates would break
    the layer-membership invariant). One short beam + one selection per
    wave instead of ~10 descent kernels, with the same recall recovery.
    """
    cfg = host.cfg
    metric = canonical_metric(host.metric)
    store = host.store
    if slots is None:
        alive_slots = np.flatnonzero(host.levels >= 0)
    else:
        slots = np.unique(np.asarray(slots, np.int64))
        alive_slots = slots[host.levels[slots] >= 0]
    if len(alive_slots) == 0:
        return
    ncap = host.neighbors.shape[1]
    store.ensure_capacity(ncap)
    cap_pad = bucket_pow2(ncap)
    L_all = host.neighbors.shape[0]
    Wd = host.neighbors.shape[2]

    def pad_rows(a, fill, shape):
        if a.shape == shape:
            return a          # pow2-exact capacity: skip a GB-scale copy
        out = np.full(shape, fill, a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    vectors_dev = chunked_put(store.vectors[:ncap], 0,
                              shape=(cap_pad, store.dim))
    sq_dev = jnp.asarray(pad_rows(store.sq_norms[:ncap], 0, (cap_pad,)))
    # compact jagged upper storage, mirroring bulk_insert_device
    # (levels are fixed during refinement, so the level-ranked
    # assignment comes straight from the host levels)
    m_up = cfg.m
    nb0_dev = chunked_put(host.neighbors[0], -1, shape=(cap_pad, Wd))
    lv_all = np.full(cap_pad, -1, np.int32)
    lv_all[:ncap] = host.levels[:ncap]
    ups, u_counts, nbU_tabs, umap_dev = _compact_upper_tables(
        host, lv_all, cap_pad, L_all, m_up)
    levels_dev = jnp.asarray(pad_rows(host.levels[:ncap], -1, (cap_pad,)))
    alive_dev = levels_dev >= 0
    qvec_dev = qscale_dev = block_scale = None
    from hnsw_tpu.ops.distance import registered
    if quant_descent and registered(metric) is None:
        gs = float(np.abs(store.vectors[:ncap]).max()) / 127.0 or 1.0
        qh = np.clip(np.rint(store.vectors[:ncap] / gs),
                     -127, 127).astype(np.int8)
        qvec_dev = chunked_put(qh, 0, shape=(cap_pad, store.dim))
        qscale_dev = jnp.asarray(np.full((cap_pad,), gs, np.float32))
        block_scale = jnp.asarray(np.float32(gs))
        if block_m is None and cap_pad * Wd * store.dim > 5 * 1024 ** 3:
            # HBM guard, set for a 16 GB device: full blocks would not
            # leave room for the descent working set (2M+ builds)
            block_m = max(8, Wd // 2)
            if cap_pad * block_m * store.dim > 5 * 1024 ** 3:
                block_m = 8
    n_cand = min(cfg.ef_construction, 2 * cfg.m_base)

    for w0 in range(0, len(alive_slots), wave):
        wslots = alive_slots[w0:w0 + wave]
        wlevels = host.levels[wslots]
        W = len(wslots)
        cur_wave = wave
        wslots_pad = np.full(cur_wave, -1, np.int64)
        wslots_pad[:W] = wslots
        wsl_dev = jnp.asarray(np.where(wslots_pad >= 0, wslots_pad, 0)
                              .astype(np.int32))
        nbr_blocks = None
        if qvec_dev is not None:
            from hnsw_tpu.core.state import _gather_blocks
            # drop the PREVIOUS wave's DeviceGraph (it pins the old
            # block tensor) before gathering the new one — at 2M+ two
            # live block tensors alone would exceed HBM
            g = None  # noqa: F841
            nbr_blocks = _gather_blocks(qvec_dev, nb0_dev,
                                        block_m=block_m)
        g = DeviceGraph(vectors=vectors_dev, sq_norms=sq_dev,
                        neighbors=nb0_dev[None], levels=levels_dev,
                        alive=alive_dev,
                        entry=jnp.asarray(np.int32(host.entry)),
                        qvec=qvec_dev, qscale=qscale_dev,
                        nbr_blocks=nbr_blocks, block_scale=block_scale,
                        nbr_upper=(tuple(nbU_tabs) if nbU_tabs is not None
                                   else None),
                        upper_map=umap_dev)
        wq = vectors_dev[wsl_dev]
        if local:
            nb0_dev = _local_repair_wave(
                g, nb0_dev, vectors_dev, sq_dev, wsl_dev,
                jnp.asarray(wslots_pad >= 0),
                deg=cfg.max_degree(0), n_cand=n_cand, metric=metric,
                hops=local_hops,
                ef=max(cfg.ef_construction, n_cand),
                diversify=cfg.diversify,
                reverse_diversify=cfg.reverse_diversify)
            continue
        cand_d, cand_i = construction_descent(
            g, wq, ef=max(cfg.ef_construction, n_cand), m_out=n_cand,
            metric=metric, max_hops=cfg.max_hops)
        # release the eager neighbors=nb0_dev[None] copy (see
        # bulk_insert_device) before the donated layer updates
        g = None  # noqa: F841

        max_l = int(wlevels.max(initial=0))
        for layer in range(0, min(max_l, L_all - 1) + 1):
            part = np.flatnonzero(wlevels >= layer)
            if len(part) == 0:
                continue
            deg = cfg.max_degree(layer)
            part_pad = np.full(cur_wave, -1, np.int64)
            part_pad[:len(part)] = part
            rows = _assemble_refine_rows(
                vectors_dev, sq_dev, cand_d[layer], cand_i[layer],
                wsl_dev, jnp.asarray(part_pad.astype(np.int32)),
                deg=deg, n_cand=n_cand, metric=metric,
                diversify=cfg.diversify)
            tgt_slots = jnp.where(
                jnp.asarray(part_pad) >= 0,
                wsl_dev[jnp.clip(jnp.asarray(part_pad.astype(np.int32)),
                                 0, cur_wave - 1)],
                cap_pad)
            Wl = Wd if layer == 0 else m_up
            full_rows = jnp.concatenate(
                [rows, jnp.full((cur_wave, Wl - deg), -1, jnp.int32)],
                axis=1) if Wl > deg else rows
            if layer == 0:
                nb_l = nb0_dev
                rows_n = cap_pad
                tgt_rows = tgt_slots
            else:
                nb_l = nbU_tabs[layer - 1]
                rows_n = nb_l.shape[0]
                tr = umap_dev[jnp.clip(tgt_slots, 0, cap_pad - 1)]
                tgt_rows = jnp.where((tgt_slots < cap_pad) & (tr >= 0),
                                     tr, rows_n)
            if layer == 0:
                nb0_dev = None  # release: nb_l's buffer is donated next
            else:
                nbU_tabs[layer - 1] = None
            nb_l = _scatter_rows(nb_l, tgt_rows, full_rows)
            rev_t = rows.reshape(-1)
            rev_s = jnp.repeat(tgt_slots.astype(jnp.int32), deg)
            rev_t = jnp.where((rev_t >= 0) & (rev_s < cap_pad), rev_t, -1)
            rev_s = jnp.where(rev_t >= 0, rev_s, -1)
            nb_l = _reverse_update(nb_l, vectors_dev, sq_dev, rev_t,
                                   rev_s, deg=deg, metric=metric,
                                   diversify=cfg.reverse_diversify,
                                   row_of=None if layer == 0 else umap_dev)
            if layer == 0:
                nb0_dev = nb_l
            else:
                nbU_tabs[layer - 1] = nb_l

    _sparse_sync(host, nb0_dev, nbU_tabs, ups, u_counts, ncap)
