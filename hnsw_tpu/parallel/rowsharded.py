"""ONE graph, layer-0 rows sharded across devices (SURVEY.md §7.2 M6).

The reference sketches — but never builds — a distributed sharded graph
(/root/reference/hnsw-extensions/hnsw-extensions.md:233-271: consistent
hashing, gRPC transport, replicas). Its device form needs no transport:
shard the layer-0 neighbor table and the vector store row-wise over the
mesh, replicate the (tiny) entry structure, and exchange the per-hop
frontier with XLA collectives.

Why this exists next to parallel/sharded.py: query-sharding (DP)
replicates the whole graph per device and partition-sharding (EP)
builds S independent sub-graphs — neither serves a SINGLE graph larger
than one device's HBM. Row-sharding does.

Design (trade-offs inherited from core/search.py):

  * Every device runs the SAME lockstep beam over ALL queries — pool
    state is replicated compute (cheap sorts/merges).
    What is sharded is the HBM-bound part: the neighbor-row gather and
    the candidate-vector gather, each device touching only rows it
    owns. Exactly one device owns any row, so the exchange is an
    owner-masked contribution + ``psum`` (an all-reduce):
      - neighbor ids   [B, E*M]  int32  (~256 KB at B=1024, E=2, M=32)
      - candidate dist [B, E*M]  f32    (same)
    vs all-gathering gathered vectors [B, E*M, D] — D× more bytes.
    ppermute rings buy nothing here: the frontier is needed by ALL
    devices next hop (the pool is replicated), so the collective is an
    all-reduce by nature, not a shift.

  * Entry = replicated pivot table (Graph.entry_mode="pivots", the
    engine's replacement for upper-layer descent: one matmul over
    ~sqrt(N) pivots). The blueprint's "replicated
    upper layers" would add pointer-chasing hops whose row gathers are
    shard-remote — strictly worse than the pivot matmul that is already
    the production entry mode at scale (CLAUDE.md block_hop rows).

  * Distances are computed by the owning device at HIGHEST precision
    against its f32 (or fp16) shard rows and summed exactly once, so
    results match the single-device pivot-seeded search bit-for-bit on
    the same graph (tests/test_sharded.py asserts parity).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from hnsw_tpu.config import canonical_metric
from hnsw_tpu.core.search import _bitonic_merge, _EXP_BIT
from hnsw_tpu.ops.distance import INF_DIST, gathered_dist, pairwise_dist


class RowShards(NamedTuple):
    """Host-prepared arrays for the row-sharded single graph.

    Rows are padded so cap divides the mesh size; pad rows carry
    nbr0 = -1 and are never referenced (neighbor ids only point at real
    rows), so they need no validity mask.
    """
    nbr0: jnp.ndarray        # [cap_pad, M0] int32 GLOBAL ids, -1 empty
    vectors: jnp.ndarray     # [cap_pad, D] f32 / fp16 rows
    sq_norms: jnp.ndarray    # [cap_pad] f32
    pivot_ids: jnp.ndarray   # [Pv] int32 global slot ids (replicated)
    pivot_vecs: jnp.ndarray  # [Pv, D] f32 (replicated)
    pivot_sq: jnp.ndarray    # [Pv] f32


def make_row_shards(g, n_shards: int,
                    dtype: Optional[str] = None) -> RowShards:
    """Slice a built Graph's layer-0 state into mesh-ready arrays.

    ``dtype="float16"`` stores shard rows in fp16 (the capacity mode;
    scoring upcasts to f32 — same physics as hbm_mode="float16").
    Dead nodes are prefolded: edges to them become -1 (the same
    tombstone prefold state.from_host does).
    """
    host = g.host
    used = g.slots.capacity_used
    nbr0 = np.array(host.neighbors[0][:used], np.int32)
    alive = g.store.alive[:used]
    ok = (nbr0 >= 0) & alive[np.clip(nbr0, 0, used - 1)]
    nbr0 = np.where(ok, nbr0, -1)
    vecs = np.asarray(g.store.vectors[:used], np.float32)
    sq = np.asarray(g.store.sq_norms[:used], np.float32)
    cap_pad = -(-used // n_shards) * n_shards
    pad = cap_pad - used
    if pad:
        nbr0 = np.pad(nbr0, ((0, pad), (0, 0)), constant_values=-1)
        vecs = np.pad(vecs, ((0, pad), (0, 0)))
        sq = np.pad(sq, (0, pad))
    pids, pvecs, psq = g._pivot_arrays()
    if dtype == "float16":
        vecs = vecs.astype(np.float16)
    return RowShards(jnp.asarray(nbr0), jnp.asarray(vecs),
                     jnp.asarray(sq), pids, pvecs, psq)


def rowsharded_graph_search(shards: RowShards, queries: jnp.ndarray, *,
                            k: int, ef: int, seeds: int = 16,
                            metric: str = "cosine", max_hops: int = 128,
                            expand: int = 2, mesh: Mesh,
                            axis: str = "data"
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Search ONE row-sharded graph for a replicated query batch.

    Returns (dists [B, k], global slot ids [B, k]); -1 = miss. The
    row axis of nbr0/vectors/sq_norms is sharded over ``axis``; queries
    and the pivot table are replicated.
    """
    metric = canonical_metric(metric)
    S = mesh.shape[axis]
    if shards.nbr0.shape[0] % S:
        raise ValueError(f"cap {shards.nbr0.shape[0]} not divisible by "
                         f"mesh size {S}; use make_row_shards")
    n_local = shards.nbr0.shape[0] // S
    Pp = max(ef, k)
    E = max(1, min(expand, Pp))
    M = shards.nbr0.shape[1]
    s_seeds = int(min(seeds, shards.pivot_ids.shape[0], Pp))

    def local(nbr0, vecs, sq, pids, pvecs, psq, q):
        B = q.shape[0]
        q = q.astype(jnp.float32)
        q_sq = jnp.sum(q * q, axis=-1)
        shard = jax.lax.axis_index(axis)
        rows = jnp.arange(B)

        def gather_exchange(ids, take):
            """Owner-gathers + psum: neighbor rows of [B, E] frontier."""
            loc = ids - shard * n_local
            own = take & (loc >= 0) & (loc < n_local)
            r = nbr0[jnp.clip(loc, 0, n_local - 1)]       # [B, E, M]
            contrib = jnp.where(own[:, :, None], r + 1, 0)
            return jax.lax.psum(contrib, axis) - 1        # -1 when dead

        def score_exchange(cand, ok):
            """Owner-scores + psum: exact distances for [B, C] ids."""
            loc = cand - shard * n_local
            own = ok & (loc >= 0) & (loc < n_local)
            safe = jnp.clip(loc, 0, n_local - 1)
            cv = vecs[safe]
            if cv.dtype != jnp.float32:
                cv = cv.astype(jnp.float32)
            d = gathered_dist(q, cv, sq[safe], q_sq, metric=metric,
                              precision=jax.lax.Precision.HIGHEST)
            d = jax.lax.psum(jnp.where(own, d, 0.0), axis)
            return jnp.where(ok, d, INF_DIST)

        # ---- entry: replicated pivot matmul (exact, all devices) -------
        pd = pairwise_dist(q, pvecs, v_sq=psq, metric=metric,
                           precision=jax.lax.Precision.HIGHEST)
        neg, j = jax.lax.top_k(-pd, s_seeds)              # ascending
        seed_ids = pids[j]                                # [B, s] global
        seed_d = -neg

        pool_i = jnp.full((B, Pp), -1, jnp.int32).at[:, :s_seeds].set(
            seed_ids)
        pool_d = jnp.full((B, Pp), INF_DIST, jnp.float32
                          ).at[:, :s_seeds].set(seed_d)
        expanded = pool_i < -1

        def select(pool_d, pool_i, expanded):
            sel_d = jnp.where(expanded | (pool_i < 0), INF_DIST, pool_d)
            negv, jj = jax.lax.top_k(-sel_d, E)
            best = -negv
            worst = jnp.max(pool_d, axis=1)
            return jj, best < worst[:, None]

        j0, take0 = select(pool_d, pool_i, expanded)

        def cond(state):
            *_, take, hop = state
            return (hop < max_hops) & jnp.any(take)

        def body(state):
            pool_d, pool_i, expanded, jj, take, hop = state
            cur = jnp.take_along_axis(pool_i, jj, axis=1)     # [B, E]
            expanded = expanded.at[rows[:, None], jj].max(take)
            nbrs = gather_exchange(
                jnp.where(take, cur, 0), take).reshape(B, E * M)
            nb_ok = (nbrs >= 0) & jnp.repeat(take, M, axis=1)
            in_pool = (nbrs[:, :, None] == pool_i[:, None, :]).any(-1)
            nb_ok = nb_ok & (~in_pool)
            cand = jnp.where(nb_ok, nbrs, -1)
            d = score_exchange(jnp.where(nb_ok, nbrs, 0), nb_ok)
            # same-hop diamond twins: O(C^2) id-equality dedup before the
            # bitonic merge (core/search.py's hole-free-pool invariant)
            C = cand.shape[1]
            tri = jnp.tril(jnp.ones((C, C), bool), k=-1)
            dup = ((cand[:, :, None] == cand[:, None, :])
                   & (cand[:, :, None] >= 0) & tri[None]).any(-1)
            d = jnp.where(dup, INF_DIST, d)
            cand = jnp.where(dup, -1, cand)
            ei = jnp.where(expanded & (pool_i >= 0), pool_i | _EXP_BIT,
                           pool_i)
            pool_d, packed = _bitonic_merge(pool_d, ei, d, cand, Pp)
            expanded = packed >= _EXP_BIT
            pool_i = jnp.where(packed >= 0, packed & (_EXP_BIT - 1),
                               packed)
            jj, take = select(pool_d, pool_i, expanded)
            return pool_d, pool_i, expanded, jj, take, hop + 1

        state = (pool_d, pool_i, expanded, j0, take0,
                 jnp.int32(0))
        pool_d, pool_i, *_ = jax.lax.while_loop(cond, body, state)
        fd, fi = jax.lax.sort((pool_d, pool_i), dimension=1, num_keys=1,
                              is_stable=True)
        fi = jnp.where(fd >= INF_DIST, -1, fi)
        return fd[:, :k], fi[:, :k]

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(), P(), P()),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(f)(shards.nbr0, shards.vectors, shards.sq_norms,
                      shards.pivot_ids, shards.pivot_vecs,
                      shards.pivot_sq, queries)
