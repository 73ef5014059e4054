"""IVF (inverted-file) index — the device large-N strategy.

The reference routes candidates through LSH buckets and k-means
partitions (hybrid/partitioner.go, hybrid/lsh.go) but still scores one
query at a time. This index is the same idea rebuilt for matmuls:

  * k-means centroids trained on device (chunked distance matmuls +
    segment-sum updates);
  * vectors laid out PARTITION-MAJOR in a padded [P, cap_p, D] block
    array — per-partition scans are contiguous, no row gathers;
  * a query batch probes its top-nprobe partitions: queries are grouped
    by partition on host, then ONE batched einsum scores every
    (partition, its-queries, its-vectors) block, and per-query top-k
    merges the probed partitions' candidates.

Work scales with nprobe/P of the exact scan while staying 100% matmul.
This is the sweet spot between the exact tier (N <= ~100k: just scan)
and sharded multi-chip serving (parallel/sharded.py).
"""

from __future__ import annotations

import functools
from typing import Any, Hashable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hnsw_tpu.config import canonical_metric
from hnsw_tpu.core.state import bucket_pow2
from hnsw_tpu.ops.distance import (INF_DIST, np_gram_epilogue,
                                   pairwise_dist)
from hnsw_tpu.ops.topk import merge_topk, topk_smallest
from hnsw_tpu.utils.keystore import HostVectorStore, SlotMap
from hnsw_tpu.utils.transfer import chunked_put


def _gathered_block_put(vectors: np.ndarray, block_slot: np.ndarray,
                        block_valid: np.ndarray, bs: int, dim: int):
    """Assemble the padded [NB, bs, dim] f32 block table on DEVICE from
    host ``vectors`` without ever materializing the padded host copy:
    bounded host chunks (gathered rows for a run of blocks) stream into
    a preallocated device buffer via the donated row-updater, exactly
    like chunked_put — but the source rows are a gather, so chunked_put
    itself (contiguous-prefix semantics) cannot express it."""
    from hnsw_tpu.utils.transfer import _CHUNK_BYTES, _updater

    NB = block_slot.shape[0]
    row = bs * dim * 4
    step = max(1, _CHUNK_BYTES // row)
    step = 1 << (step.bit_length() - 1)
    step = min(step, max(NB, 1))
    if NB * row <= _CHUNK_BYTES:
        blocks = np.zeros((NB, bs, dim), np.float32)
        sl = np.clip(block_slot, 0, None)
        blocks[:] = vectors[sl]
        blocks[~block_valid] = 0
        return jnp.asarray(blocks)
    upd = _updater(3)
    buf = jnp.zeros((NB, bs, dim), jnp.float32)
    chunk = np.zeros((step, bs, dim), np.float32)
    for c0 in range(0, NB, step):
        m = min(step, NB - c0)
        sl = np.clip(block_slot[c0:c0 + m], 0, None)
        chunk[:m] = vectors[sl]
        chunk[:m][~block_valid[c0:c0 + m]] = 0
        # dynamic_update_slice CLAMPS the start index: a full-size tail
        # chunk would slide back over valid rows. Ship the exact tail
        # (one extra compile, once).
        payload = chunk if m == step else np.ascontiguousarray(chunk[:m])
        buf = upd(buf, jnp.asarray(payload), np.int32(c0))
    return buf


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_probed(dk, ck, block_slot, pp, rr, valid, *, k: int):
    """Per-query merge of probed block results, on device.

    dk/ck: [NB, Qp, kk]; block_slot: [NB, bs]; pp/rr: [Q, T] (block id,
    row-in-block) per probed block; valid: [Q, T].
    Returns (dists [Q, k], slots [Q, k]) — the only D2H payload.
    """
    d_sel = jnp.where(valid[:, :, None], dk[pp, rr], INF_DIST)  # [Q,T,kk]
    c_sel = ck[pp, rr]
    s_sel = jnp.take_along_axis(block_slot[pp],
                                jnp.clip(c_sel, 0, None), axis=2)
    Q = pp.shape[0]
    d_all = d_sel.reshape(Q, -1)
    s_all = jnp.where(d_sel < INF_DIST / 2, s_sel, -1).reshape(Q, -1)
    kk = min(k, d_all.shape[1])
    dd, pos = topk_smallest(d_all, kk)
    ss = jnp.take_along_axis(s_all, pos, axis=1)
    return dd, jnp.where(dd < INF_DIST / 2, ss, -1)


@functools.partial(jax.jit, static_argnames=("metric",))
def _assign_parts(vectors, cents, metric: str):
    """Nearest-centroid assignment, chunked on device ([N] int32 D2H).

    Chunking keeps the [ch, P] distance block small; bf16 (DEFAULT)
    matmul precision is fine for partition routing.
    """
    n, d = vectors.shape
    ch = min(65536, n)
    vc = vectors.reshape(n // ch, ch, d)

    def one(chunk):
        dist = pairwise_dist(chunk, cents, metric=metric,
                             precision=jax.lax.Precision.DEFAULT)
        return jnp.argmin(dist, axis=1).astype(jnp.int32)

    return jax.lax.map(one, vc).reshape(-1)


@functools.partial(jax.jit, static_argnames=("metric",))
def _kmeans_step(vectors, valid, cents, metric: str):
    """One Lloyd's iteration, fully device-resident.

    vectors [N, D] (N pow2-bucketed, zero-padded), valid [N] bool,
    cents [P, D].  Assignment + one-hot segment sums are chunked
    matmuls; only the updated [P, D] table leaves the step.
    """
    n, d = vectors.shape
    p = cents.shape[0]
    ch = min(65536, n)
    vc = vectors.reshape(n // ch, ch, d)
    mc = valid.reshape(n // ch, ch)

    def one(args):
        chunk, m = args
        dist = pairwise_dist(chunk, cents, metric=metric,
                             precision=jax.lax.Precision.DEFAULT)
        a = jnp.argmin(dist, axis=1)
        oh = jax.nn.one_hot(a, p, dtype=jnp.float32) * m[:, None]
        s = jnp.einsum("cp,cd->pd", oh, chunk,
                       preferred_element_type=jnp.float32)
        return s, jnp.sum(oh, axis=0)

    ss, cc = jax.lax.map(one, (vc, mc))
    sums, counts = ss.sum(0), cc.sum(0)
    new = sums / jnp.maximum(counts, 1.0)[:, None]
    return jnp.where((counts > 0)[:, None], new, cents)


def _device_assign(vectors: np.ndarray, cents, metric: str) -> np.ndarray:
    """Host wrapper: pow2-bucket N (bounded recompiles), assign on device."""
    n = vectors.shape[0]
    nb = bucket_pow2(max(n, 1), 1024)
    # chunked H2D with the padding made on device
    vd = chunked_put(np.asarray(vectors, np.float32),
                     shape=(nb, vectors.shape[1]))
    a = np.asarray(_assign_parts(vd, jnp.asarray(cents, jnp.float32),
                                 metric))
    return a[:n]


@functools.partial(jax.jit, static_argnames=("metric", "k"))
def _scan_blocks(queries, q_rows, blocks, block_sq, block_valid,
                 metric: str, k: int):
    """Score grouped queries against their partition blocks.

    queries:    [Q, D]
    q_rows:     [P, Qp] int32 query indices probing partition p (-1 pad)
    blocks:     [P, C, D]; block_sq [P, C]; block_valid [P, C]
    returns (dists [P, Qp, k], cols [P, Qp, k])
    """
    safe = jnp.clip(q_rows, 0, queries.shape[0] - 1)
    qg = queries[safe]                                   # [P, Qp, D]
    # HIGHEST: the probed scan IS the final ranking (no rerank stage).
    # DEFAULT (bf16) cannot order near-ties inside tight clusters —
    # measured 1M clustered recall froze at .41 across ALL nprobe.
    gram = jnp.einsum("pqd,pcd->pqc", qg, blocks,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    q_sq = jnp.sum(queries * queries, axis=-1)[safe]     # [P, Qp]
    if metric == "cosine":
        d = 1.0 - gram * jax.lax.rsqrt(
            q_sq[:, :, None] * block_sq[:, None, :] + 1e-30)
    elif metric == "dot":
        d = -gram
    else:
        d = jnp.maximum(q_sq[:, :, None] + block_sq[:, None, :]
                        - 2.0 * gram, 0.0)
        if metric == "l2":
            d = jnp.sqrt(d)
    d = jnp.where(block_valid[:, None, :], d, INF_DIST)
    d = jnp.where((q_rows >= 0)[:, :, None], d, INF_DIST)
    dk, ck = topk_smallest(d, min(k, d.shape[-1]))
    return dk, ck


class IVFIndex:
    """Partition-scanned ANN index (all-matmul)."""

    def __init__(self, num_partitions: int = 64,
                 nprobe: "int | str" = "auto",
                 metric: str = "cosine", seed: int = 42,
                 kmeans_iters: int = 10, auto_recall: float = 0.9):
        """``nprobe`` — partitions probed per query. An int fixes it;
        "auto" (default) calibrates the smallest nprobe meeting
        ``auto_recall`` against a sampled exact oracle over the index's
        own data, re-measured when the index grows/shrinks >25%
        (a fixed nprobe=8 silently served recall
        0.51 on random 10k — unclustered data needs high nprobe and
        nothing told the caller)."""
        if isinstance(nprobe, str):
            if nprobe != "auto":
                raise ValueError(f"bad nprobe {nprobe!r}")
        elif nprobe > num_partitions:
            raise ValueError("nprobe must be <= num_partitions")
        self.P = num_partitions
        self.nprobe = nprobe
        self.auto_recall = float(auto_recall)
        #: (resolved nprobe, index size at calibration)
        self._auto_cache: Optional[Tuple[int, int]] = None
        self.metric = canonical_metric(metric)
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.slots = SlotMap()
        self.centroids: Optional[np.ndarray] = None
        # partition-major storage (host authoritative, device mirror).
        # Vectors live in a dense padded store and membership in
        # per-partition slot sets + a slot->partition map, so _sync and
        # delete are vectorized / O(1) instead of Python-looped over N.
        self.store = HostVectorStore()
        self._members: List[set] = [set() for _ in range(self.P)]
        self._part_of: dict = {}
        self._dirty = True
        self._dev = None

    def __len__(self) -> int:
        return len(self.slots)

    # -- training -------------------------------------------------------------
    def _train(self, vectors: np.ndarray) -> np.ndarray:
        """Device k-means (Lloyd's): everything stays on device.

        Only the final [P, D] centroid table leaves the device (a host
        loop would ship an [N, P] distance matrix every iteration —
        ~1 GB/iter at 1M).
        """
        rng = np.random.default_rng(self.seed)
        n = vectors.shape[0]
        init = rng.choice(n, size=min(self.P, n), replace=False)
        cents = vectors[init].copy()
        if len(cents) < self.P:  # fewer points than partitions
            extra = rng.standard_normal(
                (self.P - len(cents), vectors.shape[1])).astype(np.float32)
            cents = np.concatenate([cents, extra])
        nb = bucket_pow2(max(n, 1), 1024)
        valid = np.zeros(nb, bool)
        valid[:n] = True
        # chunked H2D: at 8M x 128 the f32 table is 4.3 GB, and the
        # padding is made on device, not staged on the host
        v_dev = chunked_put(np.asarray(vectors, np.float32),
                            shape=(nb, vectors.shape[1]))
        m_dev = jnp.asarray(valid)
        c_dev = jnp.asarray(cents.astype(np.float32))
        for _ in range(self.kmeans_iters):
            c_dev = _kmeans_step(v_dev, m_dev, c_dev, self.metric)
        return np.asarray(jax.block_until_ready(c_dev))

    # -- mutation ----------------------------------------------------------------
    def build(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if len(set(keys)) != len(keys):
            raise ValueError("duplicate keys in build batch")
        self.centroids = self._train(vectors)
        assign = _device_assign(vectors, self.centroids, self.metric)
        self._commit(keys, vectors, assign)

    def add(self, key: Hashable, vector) -> None:
        self.batch_add([key], np.asarray(vector, np.float32)[None])

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if self.centroids is None:
            self.build(keys, vectors)
            return
        assign = _device_assign(vectors, self.centroids, self.metric)
        self._commit(keys, vectors, assign)

    def _commit(self, keys, vectors, assign) -> None:
        for k_ in keys:
            if k_ in self.slots:
                self.delete(k_)
        slot_arr = np.asarray([self.slots.assign(k_)[0] for k_ in keys],
                              np.int64)
        self.store.put_batch(slot_arr, vectors)
        for slot, p in zip(slot_arr, assign):
            self._members[int(p)].add(int(slot))
            self._part_of[int(slot)] = int(p)
        self._dirty = True

    def delete(self, key: Hashable) -> bool:
        slot = self.slots.slot_of(key)
        if slot is None:
            return False
        self.slots.release(key)
        self.store.kill(slot)
        p = self._part_of.pop(slot, None)
        if p is not None:
            self._members[p].discard(slot)
        self._dirty = True
        return True

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        return [self.delete(k) for k in keys]

    # -- device layout --------------------------------------------------------------
    #: fixed block size: partitions split into [*, BS] chunks so scan
    #: work tracks TRUE partition sizes instead of the max (skewed
    #: partitions otherwise pad every partition to the largest — at
    #: 200k clustered that made IVF slower than the exact scan).
    BLOCK = 1024

    def _sync(self):
        if not self._dirty and self._dev is not None:
            return self._dev
        dim = self.store.dim or 1
        sizes = [len(m) for m in self._members]
        bs = min(self.BLOCK, bucket_pow2(max(max(sizes, default=1), 1), 8))
        # partition -> list of block indices
        part_blocks: List[List[int]] = [[] for _ in range(self.P)]
        rows = []
        for p, mem in enumerate(self._members):
            mem_arr = np.fromiter(mem, np.int64, len(mem))
            for c0 in range(0, max(len(mem_arr), 1), bs):
                part_blocks[p].append(len(rows))
                rows.append((p, mem_arr[c0:c0 + bs]))
        NB = len(rows)
        block_sq = np.zeros((NB, bs), np.float32)
        block_valid = np.zeros((NB, bs), bool)
        block_slot = np.full((NB, bs), -1, np.int64)
        for b, (p, mem_arr) in enumerate(rows):
            w = len(mem_arr)
            if w == 0:
                continue
            block_sq[b, :w] = self.store.sq_norms[mem_arr]
            block_valid[b, :w] = True
            block_slot[b, :w] = mem_arr
        # int32 explicitly: slots are dense and < 2^30 by construction
        # (the old jnp.asarray relied on the silent x64-disabled cast)
        self._dev_slots = chunked_put(block_slot.astype(np.int32))
        # blocks is the GB-scale padded table (NB x bs x D f32): it is
        # assembled in BOUNDED host chunks streamed into a preallocated
        # device buffer — the old full np.zeros((NB, bs, dim)) was a
        # transient 2x host-RAM spike at 8M rows
        blocks_dev = _gathered_block_put(self.store.vectors, block_slot,
                                         block_valid, bs, dim)
        self._dev = (blocks_dev, chunked_put(block_sq),
                     chunked_put(block_valid), block_slot,
                     jnp.asarray(self.centroids), part_blocks)
        self._dirty = False
        return self._dev

    # -- auto-nprobe -----------------------------------------------------------------
    def _resolve_nprobe(self) -> int:
        """Effective nprobe: the configured int, or the cached/auto
        calibrated value (re-measured when the index size drifts >25%
        from the calibration point)."""
        if not isinstance(self.nprobe, str):
            return int(self.nprobe)
        n = len(self.slots)
        c = self._auto_cache
        if c is not None and c[1] > 0 and abs(n - c[1]) <= 0.25 * c[1]:
            return c[0]
        npb = self._calibrate_nprobe()
        self._auto_cache = (npb, max(n, 1))
        return npb

    def _calibrate_nprobe(self, k: int = 10, sample: int = 32) -> int:
        """Smallest nprobe meeting ``auto_recall`` on member-derived
        probe queries vs a full exact oracle over the live store.

        Probes are perturbed OFF-node (0.85 member + 0.15 other-member
        mix — raw member probes anchor their own partition and
        over-estimate recall; same physics as HybridIndex.calibrate's
        finding). The oracle is a chunked host numpy scan (~32 probes x
        N rows: milliseconds at 10k, ~1-2 s at 1M)."""
        live = np.fromiter(self._part_of.keys(), np.int64,
                           len(self._part_of))
        n = len(live)
        if n <= 4 * k:
            return self.P          # tiny index: just scan everything
        rng = np.random.default_rng(self.seed + 1)
        pick = rng.choice(live, size=min(sample, n), replace=False)
        mix = rng.choice(live, size=len(pick))
        queries = np.asarray(0.85 * self.store.vectors[pick]
                             + 0.15 * self.store.vectors[mix], np.float32)
        q_sq = np.sum(queries * queries, axis=1)
        P_, kk = len(queries), min(k, n)
        gd = np.full((P_, kk), np.inf, np.float32)
        gi = np.full((P_, kk), -1, np.int64)
        for c0 in range(0, n, 131072):
            chunk_slots = live[c0:c0 + 131072]
            mat = self.store.vectors[chunk_slots]
            qv = queries @ mat.T
            d = np_gram_epilogue(
                qv, q_sq[:, None],
                self.store.sq_norms[chunk_slots][None], self.metric
            ).astype(np.float32)
            cat_d = np.concatenate([gd, d], axis=1)
            cat_i = np.concatenate(
                [gi, np.broadcast_to(chunk_slots, (P_, len(chunk_slots)))],
                axis=1)
            part = np.argpartition(cat_d, kk - 1, axis=1)[:, :kk]
            gd = np.take_along_axis(cat_d, part, axis=1)
            gi = np.take_along_axis(cat_i, part, axis=1)
        gts = [set(self.slots.keys_for(row)) - {None} for row in gi]
        total = sum(len(g) for g in gts) or 1
        npb = 1
        while npb <= self.P:
            keys, _ = self.batch_search(queries, kk, _nprobe=min(npb,
                                                                 self.P))
            hits = sum(len({kx for kx in row if kx is not None} & g)
                       for row, g in zip(keys, gts))
            if hits / total >= self.auto_recall:
                return min(npb, self.P)
            npb *= 2
        return self.P

    # -- search ----------------------------------------------------------------------
    def batch_search(self, queries, k: int, *,
                     _nprobe: Optional[int] = None
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        Q = queries.shape[0]
        if len(self.slots) == 0:
            return ([[None] * k for _ in range(Q)],
                    np.full((Q, k), INF_DIST, np.float32))
        npb = _nprobe if _nprobe is not None else self._resolve_nprobe()
        (blocks, block_sq, block_valid, block_slot, cents,
         part_blocks) = self._sync()
        NB = blocks.shape[0]

        # 1. probe assignment (one [Q, P] matmul)
        cd = np.asarray(pairwise_dist(jnp.asarray(queries), cents,
                                      metric=self.metric))
        probe = np.argpartition(cd, min(npb, self.P) - 1,
                                axis=1)[:, :npb]              # [Q, nprobe]

        # 2. group queries by BLOCK (host)
        per_block: List[List[int]] = [[] for _ in range(NB)]
        probe_pos: List[List[Tuple[int, int]]] = [[] for _ in range(Q)]
        for qi in range(Q):
            for p in probe[qi]:
                for b in part_blocks[int(p)]:
                    probe_pos[qi].append((b, len(per_block[b])))
                    per_block[b].append(qi)
        qp_max = bucket_pow2(max(max((len(x) for x in per_block),
                                     default=1), 1), 8)
        q_rows = np.full((NB, qp_max), -1, np.int32)
        for b, lst in enumerate(per_block):
            q_rows[b, :len(lst)] = lst

        # 3. one batched scan of all probed blocks (device-resident)
        dk, ck = _scan_blocks(jnp.asarray(queries), jnp.asarray(q_rows),
                              blocks, block_sq, block_valid,
                              self.metric, k)

        # 4. per-query merge on device; only [Q, k] returns to the host
        t_max = bucket_pow2(max(len(x) for x in probe_pos), 4)
        pp = np.zeros((Q, t_max), np.int64)
        rr = np.zeros((Q, t_max), np.int64)
        valid_t = np.zeros((Q, t_max), bool)
        for qi, lst in enumerate(probe_pos):
            for j, (b, r) in enumerate(lst):
                pp[qi, j] = b
                rr[qi, j] = r
                valid_t[qi, j] = True
        dd, ss = _merge_probed(dk, ck, self._dev_slots, jnp.asarray(pp),
                               jnp.asarray(rr), jnp.asarray(valid_t), k=k)
        dd = np.asarray(dd)
        ss = np.asarray(ss)
        keys = [self.slots.keys_for(row) for row in ss]
        if dd.shape[1] < k:
            pad = k - dd.shape[1]
            dd = np.pad(dd, ((0, 0), (0, pad)), constant_values=INF_DIST)
            for row in keys:
                row.extend([None] * pad)
        return keys, dd.astype(np.float32)

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        keys, dists = self.batch_search(
            np.asarray(query, np.float32)[None], k)
        return [(kk, float(dd)) for kk, dd in zip(keys[0], dists[0])
                if kk is not None]

    def stats(self) -> dict:
        sizes = [len(m) for m in self._members]
        return {"num_partitions": self.P, "nprobe": self.nprobe,
                "sizes_max": max(sizes), "sizes_min": min(sizes),
                "total": sum(sizes)}

    def calibration_state(self) -> dict:
        """JSON-able auto-nprobe calibration snapshot (persist through
        a serving wrapper's metadata — a reopened
        large index must not re-pay the calibration oracle scan)."""
        if self._auto_cache is None:
            return {}
        npb, n = self._auto_cache
        return {"auto_nprobe": [int(npb), int(n)]}

    def restore_calibration(self, state: Optional[dict]) -> None:
        """Inverse of calibration_state (no-op on None/empty). The
        >25% size-drift check in _resolve_nprobe re-measures stale
        restores automatically."""
        if state and state.get("auto_nprobe"):
            npb, n = state["auto_nprobe"]
            self._auto_cache = (int(npb), int(n))
