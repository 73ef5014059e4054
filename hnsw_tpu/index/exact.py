"""Exact (brute-force) index.

Capability parity with the reference ``ExactIndex`` (hybrid/exact.go:13,
61-111) — but instead of a per-query linear scan with insertion sort, the
whole dataset is scored in one batched matmul sweep with a running top-k
(ops/topk.exact_topk, or the fused kernel ops/pallas_exact on a GPU).
This is also the recall ground-truth oracle, the role the reference
gives it in hybrid/benchmark_test.go:273.
"""

from __future__ import annotations

from typing import Any, Hashable, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from hnsw_tpu.config import canonical_dtype, canonical_metric
from hnsw_tpu.ops.distance import INF_DIST, np_gram_epilogue
from hnsw_tpu.ops.pallas_exact import scan_topk
from hnsw_tpu.utils.keystore import HostVectorStore, SlotMap


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class ExactIndex:
    """Brute-force k-NN index with a host key map and a device vector store.

    API mirrors the reference VectorIndex/SearchableIndex interfaces
    (hybrid/hybrid.go:15-60): add / batch_add / search / batch_search /
    delete / batch_delete / __len__ / close.
    """

    def __init__(self, dim: Optional[int] = None, metric: str = "cosine",
                 fast_math: bool = False, hbm_dtype: str = "float32"):
        self.metric = canonical_metric(metric)
        self.slots = SlotMap()
        self.store = HostVectorStore(dim)
        self._dev: Optional[Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]] = None
        self._dirty = True
        #: CAPACITY mode: the device table is stored reduced-precision —
        #: "bf16" (2 bytes/dim, ranking fidelity ~f32 after the f32 host
        #: rerank) or "int8" (1 byte/dim; per-row scales; NOT for
        #: tightly clustered data — same physics as the int8
        #: neighbor-block finding, core/state._int8_block_fit).  The
        #: scan nominates k+margin candidates, one batched host fetch
        #: restores exact f32 ordering (utils/rerank.host_rerank).
        #: "fp16" is the tight-cluster capacity rung: same 2 bytes/dim
        #: as bf16 but 11 significand bits (~8x finer), scored at
        #: Precision.HIGH — rescues data whose within-cluster
        #: separations drown in bf16 rounding from paying f32 capacity
        #: (the graph tier's hbm_mode="float16" twin).
        #: "auto" walks the fidelity ladder int8 -> bf16 -> fp16 ->
        #: float32 with a full-density, arithmetic-faithful containment
        #: check (_reduced_fit) — clustered embeddings fall to the
        #: first rung that can actually rank them.
        hbm_dtype = canonical_dtype(
            hbm_dtype, ("float32", "bf16", "fp16", "int8", "auto"),
            "hbm_dtype")
        self.hbm_dtype = hbm_dtype
        self._resolved_hbm = hbm_dtype
        self._hbm_fit_cache: Optional[Tuple[str, int]] = None
        self._muts_since_fit = 0          # vectors changed since check
        #: bf16 scan with f32 rerank of the winners (exact final
        #: ordering up to pool membership).
        #: f32 HIGHEST stays the ground-truth default.
        self.fast_math = fast_math
        #: LATENCY tier: batches up to this size (and at most
        #: host_serve_max_rows stored vectors) are scanned on the host
        #: (native SIMD scan, numpy fallback) — a single query pays no
        #: jit dispatch or device round trip. Same exact results (f32
        #: rerank + stable ordering). 0 disables.
        self.host_serve_max_batch = 16
        self.host_serve_max_rows = 65536
        # native SIMD scan sidecar: (rows, sq, alive, n) — see
        # _host_scan_arrays. Invalidated on every mutation.
        self._host_scan = None

    # -- mutation ----------------------------------------------------------
    def add(self, key: Hashable, vector) -> None:
        slot, _ = self.slots.assign(key)
        self.store.put(slot, np.asarray(vector, np.float32))
        self._muts_since_fit += 1
        self._dirty = True
        self._host_scan = None

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self._muts_since_fit += len(keys)
        self._dirty = True
        self._host_scan = None

    def delete(self, key: Hashable) -> bool:
        slot = self.slots.release(key)
        if slot is None:
            return False
        self.store.kill(slot)
        self._dirty = True
        self._host_scan = None
        return True

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        return [self.delete(k) for k in keys]

    def __len__(self) -> int:
        return len(self.slots)

    def close(self) -> None:
        self._dev = None

    # -- search ------------------------------------------------------------
    def _reduced_fit(self, rows: np.ndarray, quant: str,
                     probes: int = 32, k: int = 10) -> float:
        """CONTAINMENT of the true f32 top-k inside the quantized scan's
        k+margin candidate pool, for off-node probes against the FULL
        table — exactly the quantity the capacity mode needs (the f32
        rerank fixes ordering but cannot recover candidates the
        quantized scan never nominated).  Full density: subsampling
        false-passes (core/state.py:124).  Off-node 0.85/0.15 member-mix
        probes: raw members anchor their own neighborhood and a 0.93
        member-overlap fit served real queries at 0.24 (first auto-rung
        attempt).  The bf16 rung matters: on EXTREMELY tight clusters
        even bf16's ~8 mantissa bits drown within-cluster separations,
        so "auto" must be able to fall all the way back to float32."""
        n = rows.shape[0]
        if n < 4 * k:
            return 1.0
        import ml_dtypes
        rng = np.random.default_rng(0)
        a = rng.choice(n, probes, replace=False)
        b = rng.choice(n, probes)
        b = np.where(b == a, (b + 1) % n, b)
        pr = (0.85 * rows[a] + 0.15 * rows[b]).astype(np.float32)
        if quant == "int8":
            amax = np.max(np.abs(rows), axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0)
            qr = (np.clip(np.rint(rows / s[:, None]), -127, 127)
                  .astype(np.int8).astype(np.float32) * s[:, None])
            kk = k + max(16, k // 2)
        else:
            qr = rows.astype(np.float32)
            kk = k + max(4, k // 8)
        # model the DEVICE scan's arithmetic, not an idealized f32
        # dequant.  int8/bf16 rungs: both matmul operands are rounded
        # to bf16 (int8 rows are dequantized to bf16 on device) with
        # f32 accumulation — an f32-dequant check passes data the bf16
        # scan then serves far below the floor.  fp16 rung: the store
        # and the query both rounded to fp16's significand (a GPU runs
        # Precision.HIGH as TF32, which holds fp16 values exactly and
        # rounds the f32 query to the same 10 stored bits); f32
        # accumulation.  All rungs keep the EXACT stored sq norms in
        # the epilogue.
        if quant == "fp16":
            qr = qr.astype(np.float16).astype(np.float32)
            prq = pr.astype(np.float16).astype(np.float32)
        else:
            qr = qr.astype(ml_dtypes.bfloat16).astype(np.float32)
            prq = pr.astype(ml_dtypes.bfloat16).astype(np.float32)
        qv = prq @ qr.T
        sq = np.sum(rows.astype(np.float64) * rows, axis=1
                    ).astype(np.float32)
        p_sq = np.sum(pr * pr, axis=-1)
        dq = np_gram_epilogue(qv, p_sq[:, None], sq[None, :], self.metric)
        kk = min(kk, n)
        qt = np.argpartition(dq, kk - 1, axis=1)[:, :kk]
        from hnsw_tpu.ops.topk import np_exact_topk
        _, gt = np_exact_topk(pr, rows, k, self.metric)
        hits = sum(len(set(gt[r]) & set(qt[r])) for r in range(probes))
        return hits / (probes * k)

    def _resolve_hbm_dtype(self, n: int) -> str:
        """Resolve "auto" once per data regime (re-checked when the
        index doubles/halves): full-density ranking-fidelity checks,
        int8 -> bf16 -> fp16 -> float32 (first rung scoring >= 0.99
        wins; fp16 costs the same HBM as bf16, so data that fails both
        2-byte rungs is what pays f32 capacity)."""
        if self.hbm_dtype != "auto":
            return self.hbm_dtype
        c = self._hbm_fit_cache
        if (c is not None and c[1] <= 2 * n and n <= 2 * c[1]
                and self._muts_since_fit <= 0.25 * c[1]):
            return c[0]
        rows = self.store.vectors[:n]
        # 0.99 containment floor: the exact tier's contract is
        # near-perfect recall.  Lower floors admit data that then serves
        # well below its fit (bf16's k+4 margin is TIGHTER than int8's
        # k+16, so its boundary bites earlier).  Borderline data costs
        # f32 capacity rather than recall.
        if self._reduced_fit(rows, "int8") >= 0.99:
            dt = "int8"
        elif self._reduced_fit(rows, "bf16") >= 0.99:
            dt = "bf16"
        elif self._reduced_fit(rows, "fp16") >= 0.99:
            dt = "fp16"
        else:
            dt = "float32"
        self._hbm_fit_cache = (dt, n)
        self._muts_since_fit = 0
        return dt

    def _sync(self):
        if self._dirty or self._dev is None:
            from ..utils.transfer import chunked_put
            n = self.slots.capacity_used
            self._resolved_hbm = self._resolve_hbm_dtype(n)
            n_pad = max(_bucket(n, 8), 8)
            sq = np.zeros((n_pad,), np.float32)
            alive = np.zeros((n_pad,), bool)
            if n:
                sq[:n] = self.store.sq_norms[:n]
                alive[:n] = self.store.alive[:n]
            scales = None
            rows = self.store.vectors[:n] if n else \
                np.zeros((0, self.store.dim), np.float32)
            # every table rides chunked_put: the capacity modes exist
            # for tens of millions of rows, where a single padded upload
            # (or a full-size host astype staging copy) would double the
            # host memory the table takes
            if self._resolved_hbm == "int8":
                scales_h = np.zeros((n_pad,), np.float32)
                v8 = np.zeros((n_pad, self.store.dim), np.int8)
                step = max(1, (64 << 20) // (4 * self.store.dim))
                for c0 in range(0, n, step):  # bounded f32 quant temps
                    r = rows[c0:c0 + step]
                    amax = np.max(np.abs(r), axis=1)
                    s = np.where(amax > 0, amax / 127.0, 1.0)
                    v8[c0:c0 + len(r)] = np.clip(
                        np.rint(r / s[:, None]), -127, 127).astype(np.int8)
                    scales_h[c0:c0 + len(r)] = s.astype(np.float32)
                scales = chunked_put(scales_h)
                v = chunked_put(v8)
            else:
                # dtype converts PER CHUNK host-side (ml_dtypes), so the
                # f32 table never transits HBM and no full-size reduced
                # staging copy is materialized
                if self._resolved_hbm == "bf16":
                    import ml_dtypes
                    dt = ml_dtypes.bfloat16
                elif self._resolved_hbm == "fp16":
                    dt = np.float16
                else:
                    dt = np.float32
                v = chunked_put(rows, shape=(n_pad, self.store.dim),
                                dtype=dt)
            self._dev = (v, chunked_put(sq), chunked_put(alive), scales)
            self._dirty = False
        return self._dev

    def batch_search_slots(self, queries: np.ndarray, k: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Core search: returns (dists [Q,k], slot ids [Q,k]; -1 = none)."""
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(self.slots) == 0:
            q = queries.shape[0]
            return (np.full((q, k), INF_DIST, np.float32),
                    np.full((q, k), -1, np.int64))
        self.store.ensure_dim(queries.shape[-1])
        n_used = self.slots.capacity_used
        if (0 < queries.shape[0] <= self.host_serve_max_batch
                and n_used <= self.host_serve_max_rows):
            return self._host_search_slots(queries, k)
        v, sq, alive, scales = self._sync()
        nq = queries.shape[0]
        q_pad = _bucket(nq)
        if q_pad != nq:
            queries = np.pad(queries, ((0, q_pad - nq), (0, 0)))
        if self._resolved_hbm != "float32":
            d_cand, i_cand = self._dispatch_capacity_scan(queries, k)
            return self._finish_capacity_scan(queries, nq, k,
                                              d_cand, i_cand)
        # the fused scan + top-k kernel serves large stores on a GPU,
        # XLA's chunked scan the rest (ops/pallas_exact.scan_topk); both
        # return f32 distances in exact order
        d, i = scan_topk(jnp.asarray(queries), v, sq, alive, k=k,
                         metric=self.metric, fast_math=self.fast_math)
        d = np.asarray(d[:nq])
        i = np.asarray(i[:nq], np.int64)
        return d, i

    def _dispatch_capacity_scan(self, queries_padded: np.ndarray, k: int):
        """Capacity-mode scan DISPATCH: reduced-precision scan
        nominating k+margin candidates (int8 needs the wider margin —
        a global per-row scale cannot rank close ties).  Returns device
        futures (jax dispatch is asynchronous) so a caller can overlap
        the previous batch's host rerank with this scan —
        ``batch_search_stream``."""
        from hnsw_tpu.ops.topk import quantized_topk_candidates
        v, sq, alive, scales = self._sync()
        margin = max(16, k // 2) if self._resolved_hbm == "int8" \
            else max(4, k // 8)
        kk = min(k + margin, v.shape[0])
        return quantized_topk_candidates(
            jnp.asarray(queries_padded), v, scales, sq, alive,
            kk=kk, metric=self.metric)

    def _finish_capacity_scan(self, queries_padded, nq: int, k: int,
                              d_cand, i_cand):
        """Capacity-mode scan FINISH: sync the candidate futures and
        restore exact f32 ordering with one batched host fetch.
        INF-dist rows are dead/padded fillers — masked so the rerank
        cannot resurrect them (the exact_topk fast-path guard)."""
        from hnsw_tpu.utils.rerank import host_rerank
        cand = np.where(np.asarray(d_cand[:nq]) >= INF_DIST, -1,
                        np.asarray(i_cand[:nq], np.int64))
        return host_rerank(self.store, self.metric, queries_padded[:nq],
                           cand, k)

    def batch_search_stream(self, batches, k: int):
        """Pipelined serving for a STREAM of query batches: batch i+1's
        device scan is dispatched BEFORE batch i's host rerank runs, so
        in the capacity modes the f32 host rerank overlaps the next
        scan — jax dispatch is asynchronous, so the device executes
        batch i+1 while the host reranks batch i.  Yields
        ``(dists [B, k], slots [B, k])`` per batch, in order.  Modes
        without a host-rerank stage just serve sequentially (there is
        nothing to overlap — XLA already pipelines pure device work)."""
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        if len(self.slots) > 0:
            self._sync()
        if len(self.slots) == 0 or self._resolved_hbm == "float32":
            for q in batches:
                yield self.batch_search_slots(q, k)
            return
        pending = None      # (queries_padded, nq, d_cand, i_cand)
        for q in batches:
            q = np.atleast_2d(np.asarray(q, np.float32))
            self.store.ensure_dim(q.shape[-1])
            nq = q.shape[0]
            q_pad = _bucket(nq)
            if q_pad != nq:
                q = np.pad(q, ((0, q_pad - nq), (0, 0)))
            d_cand, i_cand = self._dispatch_capacity_scan(q, k)
            if pending is not None:
                yield self._finish_capacity_scan(*pending)
            pending = (q, nq, k, d_cand, i_cand)
        if pending is not None:
            yield self._finish_capacity_scan(*pending)

    def _host_scan_arrays(self):
        """Sidecar for the native SIMD scan (native.exact_scan): the
        reduced-precision ladder int8 -> fp16 -> f32 (same shape as the
        device capacity ladder). int8 rows are 1/4 the memory traffic
        and ride VNNI byte-MACs — at 10k x 128 the whole store fits L2;
        cosine rows are pre-normalized. The raw f32 store stays the
        rerank source, so final ordering is exact at every rung.
        Rebuilt lazily after any mutation."""
        n = self.slots.capacity_used
        c = self._host_scan
        if c is not None and c["n"] == n:
            return c
        rows = self.store.vectors[:n]
        if self.metric == "cosine":
            inv = 1.0 / np.sqrt(np.maximum(self.store.sq_norms[:n],
                                           1e-30))
            base = np.asarray(rows * inv[:, None], np.float32)
            sq = None
        else:
            base = rows
            sq = np.ascontiguousarray(self.store.sq_norms[:n],
                                      np.float32)
        scales = row_sums = None
        if n and self._reduced_fit(rows, "int8") >= 0.99:
            amax = np.max(np.abs(base), axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            scan_rows = np.ascontiguousarray(
                np.clip(np.rint(base / s[:, None]), -127, 127), np.int8)
            scales = s
            row_sums = scan_rows.astype(np.int32).sum(axis=1)
            row_sums = np.ascontiguousarray(row_sums, np.int32)
        elif n and self._reduced_fit(rows, "fp16") >= 0.99:
            scan_rows = np.ascontiguousarray(base, np.float16)
        else:
            scan_rows = np.ascontiguousarray(base, np.float32)
        c = {"n": n, "rows": scan_rows, "sq": sq, "scales": scales,
             "row_sums": row_sums,
             "alive": np.ascontiguousarray(self.store.alive[:n],
                                           np.uint8),
             "rr_rows": np.ascontiguousarray(rows, np.float32),
             "rr_sq": np.ascontiguousarray(self.store.sq_norms[:n],
                                           np.float32)}
        self._host_scan = c
        return c

    def _host_search_slots(self, queries: np.ndarray, k: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan on host — identical results to the device path at
        f32, without the per-call device round trip. Serves the latency
        tier (the reference answers one query in ~128 us,
        parquet/README.md:69). Prefers the native fused SIMD scan
        (reduced-precision rows + f32 rerank, one C call); numpy/BLAS
        is the fallback."""
        from hnsw_tpu import native
        n = self.slots.capacity_used
        if native.available():
            c = self._host_scan_arrays()
            # pre-marshalled call per (sidecar snapshot, k): skips the
            # generic wrapper's per-call ctypes construction and
            # revalidation; the cache dies with the sidecar on any
            # mutation
            prep = c.setdefault("prepared", {}).get(k)
            if prep is None:
                margin = (max(16, k // 2) if c["rows"].dtype == np.int8
                          else max(8, k // 2))
                prep = native.PreparedScan(
                    c["rows"], k, min(max(n, k), k + margin),
                    self.metric, sq_norms=c["sq"], scales=c["scales"],
                    row_sums=c["row_sums"], alive=c["alive"],
                    rr_rows=c["rr_rows"], rr_sq=c["rr_sq"])
                c["prepared"][k] = prep
            if prep.ok:
                if not queries.flags["C_CONTIGUOUS"]:
                    queries = np.ascontiguousarray(queries)
                res = prep(queries)
                if res is not None:
                    d, i = res
                    i = np.where(d >= INF_DIST, -1, i)
                    return d, i
        v = self.store.vectors[:n]
        sq = self.store.sq_norms[:n]
        alive = self.store.alive[:n]
        qf = np.atleast_2d(np.asarray(queries, np.float32))
        qv = qf @ v.T                                        # [Q, n]
        q_sq = np.sum(qf * qf, axis=-1)
        d = np_gram_epilogue(qv, q_sq[:, None], sq[None, :], self.metric)
        d = np.where(alive[None, :], d, INF_DIST).astype(np.float32)
        kk = min(k, n)
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        dp = np.take_along_axis(d, part, axis=1)
        order = np.argsort(dp, axis=1, kind="stable")
        dd = np.take_along_axis(dp, order, axis=1)
        ii = np.take_along_axis(part, order, axis=1).astype(np.int64)
        ii = np.where(dd >= INF_DIST, -1, ii)
        if kk < k:
            pad = k - kk
            dd = np.pad(dd, ((0, 0), (0, pad)), constant_values=INF_DIST)
            ii = np.pad(ii, ((0, 0), (0, pad)), constant_values=-1)
        return dd, ii

    def batch_search(self, queries, k: int
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """Returns (keys [Q][<=k], dists [Q,k]) like SearchableIndex
        (hybrid/hybrid.go:39-60)."""
        d, i = self.batch_search_slots(np.asarray(queries, np.float32), k)
        keys = [self.slots.keys_for(row) for row in i]
        return keys, d

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        """Single-query convenience: [(key, dist), ...] trimmed of misses."""
        d, i = self.batch_search_slots(np.asarray(query, np.float32)[None], k)
        out = []
        for dist, slot in zip(d[0], i[0]):
            if slot < 0:
                continue
            out.append((self.slots.key_of(int(slot)), float(dist)))
        return out

    # -- introspection -------------------------------------------------------
    def vector_of(self, key: Hashable) -> Optional[np.ndarray]:
        s = self.slots.slot_of(key)
        return None if s is None else np.array(self.store.get(s))

    def keys(self) -> List[Any]:
        return list(self.slots.key_to_slot.keys())
