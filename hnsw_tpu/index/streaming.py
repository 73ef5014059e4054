"""Streaming exact index — serve N >> HBM (and >> RAM) at recall 1.0.

The reference's answer to datasets bigger than memory is the parquet/
arrow disk graphs (SURVEY.md §2.5-2.6): structure in RAM, vectors on
disk, per-query batched fetches. The device answer for the EXACT
tier is simpler and faster: vectors live in one memory-mapped row file
(io/mmap_store.MmapVectorStore); a query batch streams HBM-sized chunks
through the device — chunk upload, matmul scan, running top-k merge — so
device memory bounds the CHUNK, not the dataset, and host RAM holds
only the page-cache working set.

This is the disk tier of the hybrid family: recall 1.0 at any N, with
throughput bounded by host->device bandwidth instead of HBM capacity.
Reference role: parquet/vector_ops.go:321-432 (GetVectorsBatch) +
hybrid/exact.go semantics.
"""

from __future__ import annotations

from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from hnsw_tpu.config import canonical_dtype, canonical_metric
from hnsw_tpu.io.mmap_store import MmapVectorStore
from hnsw_tpu.ops.distance import INF_DIST
from hnsw_tpu.utils.keystore import SlotMap


class StreamingExactIndex:
    """Exact k-NN over disk-resident vectors, streamed in device chunks.

    API mirrors ExactIndex (hybrid/exact.go via hybrid.go:15-60);
    storage capacity is the disk, not HBM or RAM. ``chunk_rows`` bounds
    device residency: peak HBM use is one [chunk_rows, D] block plus the
    [Q, k] running winners — unless ``hbm_cache_bytes`` > 0 opts into
    pinning hot chunks (up to that budget) on device.  ``stream_dtype``
    trades the recall-1.0 guarantee for 2-4x less H2D traffic on the
    transfer-bound cold path (reduced-precision chunks + exact f32 host
    rerank of the nominated pool).
    """

    def __init__(self, directory: str, dim: Optional[int] = None,
                 metric: str = "cosine", chunk_rows: int = 131072,
                 fast_math: bool = False,
                 hbm_cache_bytes: int = 0,
                 stream_dtype: str = "float32"):
        self.metric = canonical_metric(metric)
        self.slots = SlotMap()
        self.store = MmapVectorStore(directory, dim=dim)
        self.chunk_rows = int(chunk_rows)
        self.fast_math = fast_math
        #: BANDWIDTH mode: cast each chunk on host before upload —
        #: "bf16"/"fp16" halve and "int8" quarter the H2D bytes of the
        #: cold path (this tier is explicitly host->device-bandwidth
        #: bound: 64 MB/chunk f32 at 131072 x 128) and stretch
        #: ``hbm_cache_bytes`` over 2-4x
        #: the working set.  The reduced scan nominates k+margin
        #: candidates; ONE host fetch against the f32 mmap store
        #: restores exact ordering (utils/rerank.host_rerank), exactly
        #: the ExactIndex capacity-mode contract — including its
        #: clustered-data caveat (int8 cannot rank tight clusters;
        #: fp16 is the tight-cluster 2-byte rung).  "float32" (default)
        #: keeps the recall-1.0 guarantee with no rerank.
        stream_dtype = canonical_dtype(
            stream_dtype, ("float32", "bf16", "fp16", "int8"),
            "stream_dtype")
        if (stream_dtype != "float32"
                and self.metric not in ("cosine", "l2", "sqeuclidean",
                                        "dot")):
            raise ValueError(
                "stream_dtype requires a built-in metric "
                "(the reduced scan's epilogue is device-fused)")
        self.stream_dtype = stream_dtype
        self._cache_stream_dtype = stream_dtype
        #: HBM chunk cache (opt-in, 0 = off): chunks that fit the budget
        #: stay device-resident across batches, so a warm working set
        #: serves at device-scan speed and only the cold tail streams
        #: from disk — the reference VectorStore's cache role
        #: (parquet/vector_ops.go:18-63) on the device. Mutations
        #: through THIS instance invalidate the owning chunk; do not
        #: enable it when another process/index mutates the same mmap
        #: directory (pinned chunks would go stale).
        self.hbm_cache_bytes = int(hbm_cache_bytes)
        self._cache: dict = {}          # chunk_id -> (vec, sq, alive)
        self._cache_bytes = 0

    def _invalidate(self, slots) -> None:
        for s in np.unique(np.asarray(slots, np.int64) // self.chunk_rows):
            ent = self._cache.pop(int(s), None)
            if ent is not None:
                self._cache_bytes -= ent[-1]

    # -- mutation ------------------------------------------------------------
    def add(self, key: Hashable, vector) -> None:
        slot, _ = self.slots.assign(key)
        self.store.put(slot, np.asarray(vector, np.float32))
        self._invalidate([slot])

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self._invalidate(slot_list)

    def delete(self, key: Hashable) -> bool:
        slot = self.slots.release(key)
        if slot is None:
            return False
        self.store.kill(slot)
        self._invalidate([slot])
        return True

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        return [self.delete(k) for k in keys]

    def __len__(self) -> int:
        return len(self.slots)

    def flush(self) -> None:
        self.store.flush()

    def close(self) -> None:
        self._cache.clear()
        self._cache_bytes = 0
        self.store.close()

    # -- search ---------------------------------------------------------------
    def batch_search_slots(self, queries: np.ndarray, k: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        import jax.numpy as jnp

        from hnsw_tpu.ops.topk import (exact_topk, merge_topk,
                                       quantized_topk_candidates)
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        nq = queries.shape[0]
        n = self.slots.capacity_used
        if n == 0:
            return (np.full((nq, k), INF_DIST, np.float32),
                    np.full((nq, k), -1, np.int64))
        self.store.ensure_dim(queries.shape[-1])
        rd = self.stream_dtype
        if self._cache_stream_dtype != rd:      # mode changed: drop pins
            self._cache.clear()
            self._cache_bytes = 0
            self._cache_stream_dtype = rd
        reduced = rd != "float32"
        # running-merge width: the reduced scan keeps k+margin
        # candidates per chunk so the final f32 host rerank has the
        # same containment margin as ExactIndex's capacity modes
        if reduced:
            margin = max(16, k // 2) if rd == "int8" else max(4, k // 8)
            width = min(k + margin, n)
        else:
            width = k
        qd = jnp.asarray(queries)
        best_d = jnp.full((nq, width), INF_DIST, jnp.float32)
        best_i = jnp.full((nq, width), -1, jnp.int32)
        step = self.chunk_rows
        for c0 in range(0, n, step):
            c1 = min(c0 + step, n)
            rows = c1 - c0
            cached = self._cache.get(c0 // step)
            if cached is not None and cached[0].shape[0] >= rows:
                vd, sd, ad, scd = cached[0], cached[1], cached[2], cached[3]
            else:
                pad = (-rows) % 8
                raw = self.store.vectors[c0:c1]         # disk -> page-in
                scales = None
                if rd == "int8":
                    amax = np.max(np.abs(raw), axis=1)
                    s = np.where(amax > 0, amax / 127.0, 1.0)
                    vec = np.zeros((rows + pad, self.store.dim), np.int8)
                    vec[:rows] = np.clip(np.rint(raw / s[:, None]),
                                         -127, 127).astype(np.int8)
                    scales = np.zeros((rows + pad,), np.float32)
                    scales[:rows] = s.astype(np.float32)
                else:
                    if rd == "bf16":
                        import ml_dtypes
                        dt = ml_dtypes.bfloat16
                    else:
                        dt = np.float16 if rd == "fp16" else np.float32
                    vec = np.zeros((rows + pad, self.store.dim), dt)
                    vec[:rows] = raw.astype(dt)
                sq = np.zeros((rows + pad,), np.float32)
                sq[:rows] = self.store.sq_norms[c0:c1]
                alive = np.zeros((rows + pad,), bool)
                alive[:rows] = self.store.alive[c0:c1]
                vd, sd, ad = (jnp.asarray(vec), jnp.asarray(sq),
                              jnp.asarray(alive))
                scd = None if scales is None else jnp.asarray(scales)
                # pin full chunks while the budget lasts (the last,
                # partial chunk regrows — don't pin a short version)
                nbytes = (vec.nbytes + sq.nbytes + alive.nbytes
                          + (0 if scales is None else scales.nbytes))
                if (rows == step
                        and self._cache_bytes + nbytes
                        <= self.hbm_cache_bytes):
                    self._cache[c0 // step] = (vd, sd, ad, scd, nbytes)
                    self._cache_bytes += nbytes
            if reduced:
                d, i = quantized_topk_candidates(
                    qd, vd, scd, sd, ad, kk=min(width, rows),
                    metric=self.metric)
            else:
                d, i = exact_topk(qd, vd, sd, ad, k=min(width, rows),
                                  metric=self.metric,
                                  fast_math=self.fast_math)
            if d.shape[1] < width:
                d = jnp.pad(d, ((0, 0), (0, width - d.shape[1])),
                            constant_values=INF_DIST)
                i = jnp.pad(i, ((0, 0), (0, width - i.shape[1])),
                            constant_values=-1)
            i = jnp.where(i >= 0, i + c0, -1)
            best_d, best_i = merge_topk(best_d, best_i, d, i, width)
        best_i = jnp.where(best_d >= INF_DIST, -1, best_i)
        if reduced:
            # one batched f32 fetch from the mmap store restores exact
            # ordering of the nominated pool (dead/pad rows masked)
            cand = np.asarray(best_i, np.int64)
            cand = np.where(np.asarray(best_d) >= INF_DIST, -1, cand)
            from hnsw_tpu.utils.rerank import host_rerank
            return host_rerank(self.store, self.metric, queries, cand, k)
        return np.asarray(best_d), np.asarray(best_i, np.int64)

    def batch_search(self, queries, k: int
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        d, i = self.batch_search_slots(np.asarray(queries, np.float32), k)
        keys = [self.slots.keys_for(row) for row in i]
        return keys, d

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        d, i = self.batch_search_slots(
            np.asarray(query, np.float32)[None], k)
        return [(self.slots.key_of(int(s)), float(dd))
                for dd, s in zip(d[0], i[0]) if s >= 0]
