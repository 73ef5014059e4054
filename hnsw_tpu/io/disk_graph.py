"""Disk-backed graph — ONE implementation replacing BOTH ParquetGraph
(parquet/graph.go) and ArrowGraph (arrow/graph.go).

The reference grew three HNSW implementations because each storage
backend re-implemented the graph (SURVEY.md §1 note). Here storage is a
parameter: the same core Graph persists to a directory of four tables
(vectors/layers/neighbors/metadata — schemas from parquet/storage.go:
127-168) in Parquet, Arrow IPC, or npz, with an incremental WAL for
vector churn (io/wal.IncrementalStore) and compaction on open
(parquet/graph.go:157).

Unlike the reference's disk graphs, Delete/Add never rewrite all tables
synchronously (the reference rewrites every Parquet file per single
Delete — parquet/graph.go:1115, a quirk SURVEY.md §7.4 says not to
replicate): mutations append WAL records; ``save`` / ``compact`` /
``close`` persist the full structure.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from hnsw_tpu.config import GraphConfig, StoreConfig
from hnsw_tpu.index.hnsw import Graph
from hnsw_tpu.io import table as T
from hnsw_tpu.io.wal import IncrementalStore


class DiskGraph:
    """Durable Graph bound to a directory of tables + WAL."""

    def __init__(self, directory: str, config: Optional[GraphConfig] = None,
                 store_config: Optional[StoreConfig] = None,
                 fmt: Optional[str] = None):
        self.scfg = store_config or StoreConfig(directory=directory,
                                                format=fmt or "parquet")
        if fmt is not None and self.scfg.format != fmt:
            self.scfg = StoreConfig(**{**self.scfg.__dict__,
                                       "format": fmt})
        self.scfg.validate()
        self.dir = directory
        self.fmt = self.scfg.format
        os.makedirs(directory, exist_ok=True)
        self.wal = IncrementalStore(
            os.path.join(directory, "wal"), fmt=self.fmt,
            max_changes=self.scfg.wal_max_changes,
            max_age_seconds=self.scfg.wal_max_age_seconds,
            max_log_files=self.scfg.wal_max_log_files,
            sync_writes=self.scfg.wal_sync_writes)
        self.graph = self._open(config)
        # Age-based background WAL flush (the reference's 30s flush
        # goroutine — parquet/vector_ops.go:80-95, arrow/vector_store.go:
        # 73-95). Buffered changes older than the interval hit disk even
        # with no further mutations.
        self._stop_flusher = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        interval = self.scfg.wal_flush_interval_seconds
        if interval and interval > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop, args=(interval,), daemon=True,
                name=f"hnsw-wal-flush-{os.path.basename(directory)}")
            self._flusher.start()

    def _flush_loop(self, interval: float) -> None:
        tick = min(interval, 1.0)
        while not self._stop_flusher.wait(tick):
            try:
                self.wal.flush_if_stale(interval)
            except Exception:  # never kill the daemon on a transient IO error
                pass

    # -- file paths ----------------------------------------------------------
    def _p(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.{T.ext_for(self.fmt)}")

    # -- open / load -----------------------------------------------------------
    #: WAL-delta fraction above which reopen rebuilds from scratch
    #: instead of restoring the base structure and replaying the delta
    #: (replaying most of the index through sequential inserts would be
    #: slower than one bulk build).
    INCREMENTAL_REOPEN_MAX_DELTA = 0.25

    def _open(self, config: Optional[GraphConfig]) -> Graph:
        meta_p = self._p("metadata")
        have_meta = os.path.exists(meta_p)
        meta: dict = {}
        if have_meta:
            meta = T.read_metadata(meta_p, self.fmt)
        cfg = config or (GraphConfig(**meta["config"]) if have_meta
                         else GraphConfig())
        store = None
        if self.scfg.vectors_on_disk:
            from hnsw_tpu.io.mmap_store import MmapVectorStore
            store = MmapVectorStore(os.path.join(self.dir, "vectors_mmap"))
        g = Graph(config=cfg, store=store)
        if self.scfg.hbm_mode != "full":
            g.hbm_mode = self.scfg.hbm_mode
        elif self.scfg.hbm_quantized:
            g.hbm_mode = "quantized"
        has_logs = self.wal.num_log_files > 0
        if not have_meta and not has_logs:
            return g
        base_keys, base_vecs = ([], np.zeros((0, 0), np.float32))
        if os.path.exists(self._p("vectors")):
            base_keys, base_vecs = T.read_vectors(self._p("vectors"),
                                                  self.fmt)
        # merge the WAL overlay WITHOUT deleting logs; logs are only
        # discarded after the merged state is durably persisted
        # (compaction-on-open, parquet/graph.go:157 — minus the
        # reference's delete-before-persist ordering hazard). The delta
        # comes from the overlay itself — never from comparing every
        # base row (that scan cost seconds per million keys on reopen).
        ov = self.wal.overlay() if has_logs else {}
        keys, vecs = self.wal.merge(base_keys, base_vecs, overlay=ov)
        base_set = set(base_keys) if ov else set()
        deleted = [k for k, v in ov.items()
                   if v is None and k in base_set]
        delta_keys = [k for k, v in ov.items() if v is not None]
        changed = bool(deleted or delta_keys)
        have_struct = os.path.exists(self._p("neighbors"))
        if not changed and have_struct:
            # structure on disk still valid: restore it directly
            if base_keys:
                self._restore_structure(g, base_keys, base_vecs, meta)
            if has_logs:
                self.wal.discard_logs()  # logs held nothing new
        elif keys or has_logs:
            delta = len(deleted) + len(delta_keys)
            if (have_struct and base_keys and delta <= max(
                    1, int(self.INCREMENTAL_REOPEN_MAX_DELTA
                           * len(base_keys)))):
                # INCREMENTAL reopen (reference overlay semantics parquet/incremental.go:237-352):
                # restore the persisted structure, then replay only the
                # WAL delta — one buffered add no longer turns a 1M
                # reopen into a full rebuild.
                self._restore_structure(g, base_keys,
                                        np.asarray(base_vecs, np.float32),
                                        meta)
                if deleted:
                    g.batch_delete(deleted)
                if delta_keys:
                    dvecs = np.stack([ov[k] for k in delta_keys])
                    if len(delta_keys) >= 256:
                        g.build(delta_keys, dvecs)
                    else:
                        g.batch_add(delta_keys, dvecs)
                # base tables + WAL logs still jointly describe this
                # state — keep them and skip the full persist unless
                # compaction is due (a small-delta reopen must not pay
                # a full table rewrite; parquet/graph.go:157 always
                # rewrites, a cost §7.4 says not to replicate).
                if self.wal.should_compact():
                    self._persist(g)
                    self.wal.discard_logs()
            else:
                if keys:
                    g.build(keys, vecs)
                self._persist(g)
                self.wal.discard_logs()
        # calibrate_ef results survive reopen (stale entries re-measure
        # via the >25% drift check); restored last so delta replays
        # above cannot clobber it
        g.restore_calibration(meta.get("calib"))
        return g

    def _restore_structure(self, g: Graph, keys, vecs, meta) -> None:
        """Rebuild the host graph arrays from the persisted tables —
        vectorized end to end (one np.lexsort + scatter instead of a
        Python loop per edge; the old loop cost minutes at 1M)."""
        slot_arr = g.slots.assign_fresh_batch(keys)
        g.store.put_batch(slot_arr, vecs)
        lids, kidx, nidx, dk = T.read_edges_indexed(
            self._p("neighbors"), self.fmt)
        llids, lkidx, _, ldk = T.read_edges_indexed(
            self._p("layers"), self.fmt)
        n = len(keys)
        L = int(max(lids.max(initial=0), llids.max(initial=0))) + 1
        g.host._ensure(max(n - 1, 0), L - 1)
        # dictionary position -> slot. _persist writes the SAME key list
        # to the vectors table and both edge dictionaries, so the common
        # case is an identity map onto slot_arr; fall back to the dict
        # pass only if the lists diverge (e.g. externally rewritten).
        dk_slot = (slot_arr if list(dk) == list(keys) else np.asarray(
            [-1 if (s := g.slots.slot_of(k)) is None else s
             for k in dk], np.int64))
        ldk_slot = (slot_arr if list(ldk) == list(keys) else np.asarray(
            [-1 if (s := g.slots.slot_of(k)) is None else s
             for k in ldk], np.int64))
        # levels: max layer id seen per key in the layers table
        lsl = ldk_slot[lkidx]
        lok = lsl >= 0
        np.maximum.at(g.host.levels, lsl[lok],
                      np.asarray(llids, np.int32)[lok])
        # neighbors: stable-sort edges by (layer, source); the position
        # within each group is the edge's column in the [L, cap, W] row
        src = dk_slot[kidx]
        tgt = dk_slot[nidx]
        ok = (src >= 0) & (tgt >= 0)
        lid_s = np.asarray(lids, np.int64)[ok]
        src_s, tgt_s = src[ok], tgt[ok]
        if len(src_s):
            order = np.lexsort((np.arange(len(src_s)), src_s, lid_s))
            lid_s, src_s, tgt_s = lid_s[order], src_s[order], tgt_s[order]
            grp = np.r_[True, (lid_s[1:] != lid_s[:-1])
                        | (src_s[1:] != src_s[:-1])]
            starts = np.flatnonzero(grp)
            counts = np.diff(np.r_[starts, len(src_s)])
            pos = np.arange(len(src_s)) - np.repeat(starts, counts)
            W = g.host.neighbors.shape[2]
            keep = pos < W
            g.host.neighbors[lid_s[keep], src_s[keep], pos[keep]] = \
                tgt_s[keep]
        g.host.count = n
        g.host.entry = int(meta.get("entry", -1))
        g.host.top = int(meta.get("top", L - 1))
        if g.host.entry < 0 or g.host.levels[g.host.entry] < 0:
            g.host._refresh_entry()
        g._dirty = True

    # -- persistence -------------------------------------------------------------
    def _persist(self, g: Optional[Graph] = None) -> None:
        """Write the four tables. Edge tables are assembled as numpy
        index columns and written dictionary-encoded
        (T.write_edges_indexed): the n keys are encoded ONCE, never per
        edge — persisting 1M x ~48 edges is seconds of numpy + one
        Parquet write instead of minutes of Python loops (the reference
        streams builders, parquet/graph.go:649-788)."""
        g = g or self.graph
        n = g.slots.capacity_used
        host = g.host
        stk = g.slots.slot_to_key
        # store.alive marks exactly the assigned-and-not-released slots
        # (put on assign, kill on release) — one vectorized scan
        if g.store.alive is not None and len(g.store.alive) >= n:
            slots = np.flatnonzero(g.store.alive[:n])
        else:
            slots = np.asarray([s for s in range(n)
                                if stk[s] is not None], np.int64)
        keys = [stk[s] for s in slots]
        n_live = len(slots)
        vecs = (g.store.vectors[slots] if n_live
                else np.zeros((0, g.store.dim or 0), np.float32))
        T.write_vectors(self._p("vectors"), keys, vecs, self.fmt,
                        self.scfg.compression)
        # layers table: (layer_id, key) membership — key i appears once
        # per layer 0..level(i)
        levels = (np.maximum(host.levels[slots], 0).astype(np.int64)
                  if n_live else np.zeros(0, np.int64))
        counts = levels + 1
        total = int(counts.sum())
        lkidx = np.repeat(np.arange(n_live, dtype=np.int32),
                          counts) if n_live else np.zeros(0, np.int32)
        starts = np.cumsum(counts) - counts
        lids = (np.arange(total, dtype=np.int64)
                - np.repeat(starts, counts)).astype(np.int32) \
            if n_live else np.zeros(0, np.int32)
        T.write_edges_indexed(self._p("layers"), lids, lkidx, lkidx,
                              keys, self.fmt, self.scfg.compression)
        # neighbors table: per layer, mask live edges and emit
        # (layer, src dict idx, tgt dict idx) columns
        L = max(host.top + 1, 1)
        cap = host.neighbors.shape[1]
        idx_of_slot = np.full(cap, -1, np.int32)
        if n_live:
            idx_of_slot[slots] = np.arange(n_live, dtype=np.int32)
        e_l, e_k, e_n = [], [], []
        for l in range(L):
            nb = host.neighbors[l, slots] if n_live else \
                np.zeros((0, host.neighbors.shape[2]), np.int32)
            tgt_idx = idx_of_slot[np.where(nb >= 0, nb, 0)]
            ok = (nb >= 0) & (tgt_idx >= 0)
            src_rows, _ = np.nonzero(ok)
            e_l.append(np.full(len(src_rows), l, np.int32))
            e_k.append(src_rows.astype(np.int32))
            e_n.append(tgt_idx[ok])
        T.write_edges_indexed(
            self._p("neighbors"),
            np.concatenate(e_l) if e_l else np.zeros(0, np.int32),
            np.concatenate(e_k) if e_k else np.zeros(0, np.int32),
            np.concatenate(e_n) if e_n else np.zeros(0, np.int32),
            keys, self.fmt, self.scfg.compression)
        import dataclasses as _dc
        T.write_metadata(self._p("metadata"), {
            "config": _dc.asdict(g.cfg),
            "entry": int(host.entry),
            "top": int(host.top),
            "count": int(host.count),
            "saved_at": time.time(),
            # reopened indexes skip the minutes-long calibrate_ef host
            # oracle scan
            "calib": g.calibration_state(),
        }, self.fmt)

    # -- public API (mirrors the disk graphs' surface) ----------------------------
    def add(self, key: Hashable, vector) -> None:
        self.graph.add(key, vector)
        self.wal.record_add(key, np.asarray(vector, np.float32))
        if self.wal.should_compact():
            self.compact()

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if len(keys) >= 256:
            self.graph.build(list(keys), vectors)
        else:
            self.graph.batch_add(list(keys), vectors)
        for k, v in zip(keys, vectors):
            self.wal.record_add(k, v)
        if self.wal.should_compact():
            self.compact()

    def delete(self, key: Hashable) -> bool:
        ok = self.graph.delete(key)
        if ok:
            self.wal.record_delete(key)
        return ok

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        """One in-edge sweep for the whole batch + one WAL record per
        successful key (batched under the WAL lock)."""
        flags = self.graph.batch_delete(keys)
        for k, ok in zip(keys, flags):
            if ok:
                self.wal.record_delete(k)
        return flags

    def search(self, query, k: int):
        return self.graph.search(query, k)

    def batch_search(self, queries, k: int):
        return self.graph.batch_search(queries, k)

    def __len__(self) -> int:
        return len(self.graph)

    def save(self) -> None:
        """Full structure persist + WAL flush (ArrowGraph.Save,
        arrow/graph.go:355-409)."""
        self._persist()
        self.wal.flush()
        if hasattr(self.graph.store, "flush"):
            self.graph.store.flush()  # msync the mmap store

    def compact(self) -> None:
        """Fold the WAL into the base tables (incremental.go:453-488).
        Persist first, THEN drop the logs — a crash in between leaves
        redundant logs, never lost data."""
        self._persist()
        self.wal.discard_logs()

    def optimize(self) -> None:
        """ArrowIndex.Optimize (arrow/index.go:188): flush + save."""
        self.compact()

    def close(self) -> None:
        self._stop_flusher.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
            self._flusher = None
        self.save()

    def stats(self) -> dict:
        """File sizes (arrow/storage.go:182-212 Stats)."""
        out = {}
        for name in ("vectors", "layers", "neighbors", "metadata"):
            p = self._p(name)
            out[name + "_bytes"] = (os.path.getsize(p)
                                    if os.path.exists(p) else 0)
        out["wal_log_files"] = self.wal.num_log_files
        out["count"] = len(self)
        return out
