"""Multi-device execution over a device mesh.

The reference has NO distributed backend (SURVEY.md §2.7) — a sharded
graph exists only as a prose sketch (hnsw-extensions.md:233-271:
consistent hashing + gRPC transport). The device equivalent needs no
transport at all: shardings + XLA collectives.

Two axes of scale:

  * ``shard_queries``  — index replicated, query batch sharded (serving
    data-parallelism; the analogue of the reference's worker-pool
    BatchSearch, arrow/graph.go:243-314).
  * ``shard_rows``     — vector rows sharded across devices; each device
    scores its shard and a global top-k merge runs on all-gathered
    per-shard candidates (k per device — tiny), the all-gather-free
    pattern from SURVEY.md §5's "scale the big dimension" note.

Both are shard_map programs; under jit XLA inserts the collectives.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from hnsw_tpu.config import canonical_metric
from hnsw_tpu.core.search import search_graph
from hnsw_tpu.core.state import DeviceGraph
from hnsw_tpu.ops.distance import INF_DIST
from hnsw_tpu.ops.topk import exact_topk, topk_smallest


def default_mesh(n_devices: Optional[int] = None,
                 axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def sharded_exact_topk(queries: jnp.ndarray, vectors: jnp.ndarray,
                       v_sq: jnp.ndarray, valid: jnp.ndarray, *, k: int,
                       metric: str = "cosine", mesh: Mesh,
                       axis: str = "data"
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row-sharded exact k-NN: local matmul scan + global top-k merge.

    vectors/v_sq/valid are sharded along rows; queries replicated.
    Returned indices are GLOBAL row ids. Row count must divide evenly by
    the mesh size (pad with valid=False rows).
    """
    metric = canonical_metric(metric)
    n_local = vectors.shape[0] // mesh.shape[axis]

    def local(q, v, sq, vd):
        d, i = exact_topk(q, v, sq, vd, k=min(k, n_local), metric=metric)
        shard = jax.lax.axis_index(axis)
        i = jnp.where(i >= 0, i + shard * n_local, -1)
        if d.shape[1] < k:
            pad = k - d.shape[1]
            d = jnp.pad(d, ((0, 0), (0, pad)), constant_values=INF_DIST)
            i = jnp.pad(i, ((0, 0), (0, pad)), constant_values=-1)
        # per-shard top-k is tiny: all-gather + merge on every device
        dg = jax.lax.all_gather(d, axis)            # [S, Q, k]
        ig = jax.lax.all_gather(i, axis)
        q_n = q.shape[0]
        dd = jnp.moveaxis(dg, 0, 1).reshape(q_n, -1)
        ii = jnp.moveaxis(ig, 0, 1).reshape(q_n, -1)
        dk, pos = topk_smallest(dd, k)
        ik = jnp.take_along_axis(ii, pos, axis=1)
        ik = jnp.where(dk >= INF_DIST, -1, ik)
        return dk, ik

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(), P(axis), P(axis), P(axis)),
                      out_specs=(P(), P()), check_vma=False)
    return jax.jit(f)(queries, vectors, v_sq, valid)


def sharded_quantized_candidates(queries: jnp.ndarray,
                                 table: jnp.ndarray,
                                 scales: "jnp.ndarray | None",
                                 v_sq: jnp.ndarray, valid: jnp.ndarray,
                                 *, kk: int, metric: str = "cosine",
                                 mesh: Mesh, axis: str = "data"
                                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row-sharded CAPACITY-mode scan: each device scans its own
    reduced-precision shard (bf16/fp16 table with scales=None, or int8
    with per-row scales — ops/topk.quantized_topk_candidates), nominates kk
    local candidates, and an all-gather + exact merge returns the
    global kk.  The caller restores exact f32 ordering with ONE host
    rerank of the merged pool (utils/rerank.host_rerank), exactly as in
    the single-device mode.
    Returned indices are GLOBAL row ids; rows must divide evenly by the
    mesh size (pad with valid=False rows)."""
    from hnsw_tpu.ops.topk import quantized_topk_candidates
    metric = canonical_metric(metric)
    n_local = table.shape[0] // mesh.shape[axis]
    kk = min(kk, n_local)

    def merge(q_n, d, i):
        dg = jax.lax.all_gather(d, axis)
        ig = jax.lax.all_gather(i, axis)
        dd = jnp.moveaxis(dg, 0, 1).reshape(q_n, -1)
        ii = jnp.moveaxis(ig, 0, 1).reshape(q_n, -1)
        dk, pos = topk_smallest(dd, kk)
        ik = jnp.take_along_axis(ii, pos, axis=1)
        return dk, jnp.where(dk >= INF_DIST, -1, ik)

    if scales is None:
        def local(q, t, sq, vd):
            d, i = quantized_topk_candidates(q, t, None, sq, vd,
                                             kk=kk, metric=metric)
            shard = jax.lax.axis_index(axis)
            i = jnp.where(i >= 0, i + shard * n_local, -1)
            return merge(q.shape[0], d, i)

        f = jax.shard_map(local, mesh=mesh,
                          in_specs=(P(), P(axis), P(axis), P(axis)),
                          out_specs=(P(), P()), check_vma=False)
        return jax.jit(f)(queries, table, v_sq, valid)

    def local(q, t, sc, sq, vd):
        d, i = quantized_topk_candidates(q, t, sc, sq, vd,
                                         kk=kk, metric=metric)
        shard = jax.lax.axis_index(axis)
        i = jnp.where(i >= 0, i + shard * n_local, -1)
        return merge(q.shape[0], d, i)

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                      out_specs=(P(), P()), check_vma=False)
    return jax.jit(f)(queries, table, scales, v_sq, valid)


def sharded_ivf_candidates(queries: jnp.ndarray, cents: jnp.ndarray,
                           blocks: jnp.ndarray, block_sq: jnp.ndarray,
                           block_valid: jnp.ndarray,
                           block_part: jnp.ndarray, *, nprobe: int,
                           k: int, metric: str = "cosine", mesh: Mesh,
                           axis: str = "data"
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Block-sharded IVF scan (hybrid/partitioner.go routing, scaled
    over a mesh): the [NB, bs, D] partition-block table is sharded on
    its block axis, centroids are replicated, and every device runs the
    probe routing + a probe-MASKED scan of its local blocks, nominates
    k local candidates, and a global top-k merges the all-gathered
    per-shard winners.

    block_part [NB] int32 — owning partition of each block (-1 for pad
    blocks). NB must divide evenly by the mesh size (pad with empty
    blocks).  Returned ids index the FLATTENED global [NB * bs] block
    grid (-1 = miss); callers decode to store slots via
    ``block_slot.reshape(-1)[ids]`` (index/ivf.IVFIndex layout).
    """
    metric = canonical_metric(metric)
    nb_local = blocks.shape[0] // mesh.shape[axis]
    bs = blocks.shape[1]
    kk = min(k, nb_local * bs)

    def local(q, c, b, bsq, bv, bp):
        # --- probe routing (replicated small matmul) --------------------
        gram_c = jnp.einsum("qd,pd->qp", q, c,
                            preferred_element_type=jnp.float32)
        if metric == "cosine":
            c_sq = jnp.sum(c * c, axis=-1)
            q_sq = jnp.sum(q * q, axis=-1)
            d_c = 1.0 - gram_c * jax.lax.rsqrt(
                q_sq[:, None] * c_sq[None, :] + 1e-30)
        elif metric == "dot":
            d_c = -gram_c
        else:
            c_sq = jnp.sum(c * c, axis=-1)
            q_sq = jnp.sum(q * q, axis=-1)
            d_c = q_sq[:, None] + c_sq[None, :] - 2.0 * gram_c
        _, probed = topk_smallest(d_c, min(nprobe, c.shape[0]))  # [Q, np]

        # --- probe-masked local block scan ------------------------------
        # HIGHEST: the probed scan IS the final ranking (index/ivf.py
        # _scan_blocks' clustered-near-ties finding applies unchanged)
        gram = jnp.einsum("qd,ncd->qnc", q, b,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        q_sq = jnp.sum(q * q, axis=-1)
        if metric == "cosine":
            d = 1.0 - gram * jax.lax.rsqrt(
                q_sq[:, None, None] * bsq[None, :, :] + 1e-30)
        elif metric == "dot":
            d = -gram
        else:
            d = jnp.maximum(
                q_sq[:, None, None] + bsq[None, :, :] - 2.0 * gram, 0.0)
            if metric == "l2":
                d = jnp.sqrt(d)
        hit = (bp[None, :, None] == probed[:, None, :]).any(-1)  # [Q, NBl]
        d = jnp.where(bv[None, :, :], d, INF_DIST)
        d = jnp.where(hit[:, :, None], d, INF_DIST)
        dk, ik = topk_smallest(d.reshape(q.shape[0], -1), kk)
        shard = jax.lax.axis_index(axis)
        ik = jnp.where(dk < INF_DIST,
                       ik + shard * (nb_local * bs), -1)
        if dk.shape[1] < k:
            pad = k - dk.shape[1]
            dk = jnp.pad(dk, ((0, 0), (0, pad)), constant_values=INF_DIST)
            ik = jnp.pad(ik, ((0, 0), (0, pad)), constant_values=-1)
        # per-shard winners are tiny: all-gather + merge on every device
        dg = jax.lax.all_gather(dk, axis)
        ig = jax.lax.all_gather(ik, axis)
        q_n = q.shape[0]
        dd = jnp.moveaxis(dg, 0, 1).reshape(q_n, -1)
        ii = jnp.moveaxis(ig, 0, 1).reshape(q_n, -1)
        dm, pos = topk_smallest(dd, k)
        im = jnp.take_along_axis(ii, pos, axis=1)
        return dm, jnp.where(dm >= INF_DIST, -1, im)

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(), P(), P(axis), P(axis), P(axis),
                                P(axis)),
                      out_specs=(P(), P()), check_vma=False)
    return jax.jit(f)(queries, cents, blocks, block_sq, block_valid,
                      block_part)


def sharded_graph_search(g: DeviceGraph, queries: jnp.ndarray, *, k: int,
                         ef: int, metric: str = "cosine",
                         max_hops: int = 128, mesh: Mesh,
                         axis: str = "data"
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Query-sharded HNSW search: graph replicated, batch split over the
    mesh. Query count must divide evenly by the mesh size."""
    metric = canonical_metric(metric)

    def local(graph, q):
        return search_graph(graph, q, k=k, ef=ef, metric=metric,
                            max_hops=max_hops)

    n_dev = mesh.shape[axis]
    if queries.shape[0] % n_dev:
        raise ValueError(
            f"query count {queries.shape[0]} not divisible by mesh size "
            f"{n_dev}; pad the batch")
    g_specs = jax.tree.map(lambda _: P(), g)  # replicated (incl. qvec)
    f = jax.shard_map(local, mesh=mesh, in_specs=(g_specs, P(axis)),
                      out_specs=(P(axis), P(axis)))
    return jax.jit(f)(g, queries)


def partitioned_graph_search(graphs: DeviceGraph, queries: jnp.ndarray, *,
                             k: int, ef: int, metric: str = "cosine",
                             max_hops: int = 128, mesh: Mesh,
                             axis: str = "data"
                             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Partition-sharded HNSW (expert-parallel analogue, SURVEY.md §2.7):
    each device owns an independent sub-graph over its partition of the
    data (the device version of hybrid/partitioner.go routing).
    ``graphs`` holds stacked per-partition arrays with a leading device
    axis: vectors [S, cap, D], neighbors [S, L, cap, M], entry [S], ...
    Every device searches its own sub-graph for ALL queries; the global
    top-k merges all-gathered per-partition candidates.

    Returned ids are (partition, local_slot) encoded as
    partition * cap + local_slot; -1 = miss.
    """
    metric = canonical_metric(metric)
    cap = graphs.vectors.shape[-2]

    def local(gs, q):
        g = jax.tree.map(lambda a: a[0], gs)  # this device's partition
        d, i = search_graph(g, q, k=k, ef=ef, metric=metric,
                            max_hops=max_hops)
        shard = jax.lax.axis_index(axis)
        i = jnp.where(i >= 0, i + shard * cap, -1)
        dg = jax.lax.all_gather(d, axis)           # [S, Q, k]
        ig = jax.lax.all_gather(i, axis)
        q_n = q.shape[0]
        dd = jnp.moveaxis(dg, 0, 1).reshape(q_n, -1)
        ii = jnp.moveaxis(ig, 0, 1).reshape(q_n, -1)
        dk, pos = topk_smallest(dd, k)
        ik = jnp.take_along_axis(ii, pos, axis=1)
        ik = jnp.where(dk >= INF_DIST, -1, ik)
        return dk, ik

    g_specs = jax.tree.map(lambda _: P(axis), graphs)
    f = jax.shard_map(local, mesh=mesh, in_specs=(g_specs, P()),
                      out_specs=(P(), P()), check_vma=False)
    return jax.jit(f)(graphs, queries)
