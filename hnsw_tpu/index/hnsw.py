"""Keyed HNSW graph — the flagship index.

Public API mirrors the reference ``Graph[K]``
(graph.go:305,437,534,631,843,869,898,942,1047,1116,1236,1382):
add / batch_add / search / batch_search / delete / batch_delete /
lookup / __len__ / validate, plus negative-example variants.

Split of responsibilities:
  host   — key<->slot mapping, sequential mutation semantics
           (core/host_build.HostGraph), negative-example re-scoring
  device — all query traffic (core/search.search_graph) and bulk
           construction (core/build), on padded HBM arrays

The reference's ParallelSearch / BatchSearch distinction disappears:
every search is batched; a single query is a batch of one.
The test-specific result patching in the reference ("dog query",
"bird boost" — graph.go:563-569,595-619,1338-1344) is deliberately
NOT replicated (SURVEY.md §7.4).
"""

from __future__ import annotations

from typing import Any, Hashable, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from hnsw_tpu.config import GraphConfig, canonical_dtype, canonical_metric
from hnsw_tpu.core import build as build_mod
from hnsw_tpu.core import host_build
from hnsw_tpu.core.search import search_graph
from hnsw_tpu.core.state import DeviceGraph, bucket_pow2, from_host
from hnsw_tpu.ops.distance import (INF_DIST, np_gram_epilogue,
                                   np_pairwise_dist)
from hnsw_tpu.utils.keystore import HostVectorStore, SlotMap
from hnsw_tpu.utils.rwlock import RWLock


def _writes(fn):
    """Mutation: exclusive hold on the graph's RWLock (graph.go:328's
    ``g.mu.Lock()``). Re-entrant — build() deletes replaced keys inside
    its own write hold."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._rw.write():
            return fn(self, *a, **kw)
    return wrapper


def _reads(fn):
    """Query/read path: shared hold (graph.go:328's ``g.mu.RLock()``) —
    any number of concurrent searches, all excluded while a mutation
    runs. Lazily-built serving caches (device graph, native engine,
    pivots) are written under the read hold: assignment is GIL-atomic
    and rebuilding twice is idempotent, so readers never block
    readers."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._rw.read():
            return fn(self, *a, **kw)
    return wrapper


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class Graph:
    """Device-batched HNSW index over arbitrary hashable keys."""

    def __init__(self, m: int = 16, ml: float = 0.25, ef_search: int = 20,
                 metric: str = "cosine", seed: int = 0,
                 ef_construction: int = 100,
                 config: Optional[GraphConfig] = None,
                 store=None):
        self.cfg = config or GraphConfig(m=m, ml=ml, ef_search=ef_search,
                                         metric=metric, seed=seed,
                                         ef_construction=ef_construction)
        self.cfg.validate()
        self.metric = canonical_metric(self.cfg.metric)
        self.slots = SlotMap()
        #: vector storage — RAM by default; pass an
        #: io.mmap_store.MmapVectorStore for disk-resident vectors
        #: (N >> RAM; the parquet VectorStore role).
        self.store = store if store is not None else HostVectorStore()
        self.host = host_build.HostGraph(self.cfg, self.store)
        self._dev: Optional[DeviceGraph] = None
        self._dirty = True
        #: bf16 traversal matmuls; exact reported distances off. Flip on
        #: for serving throughput.
        self.fast_math = False
        self._hbm_mode = "full"
        self._entry_mode = "descent"
        self._block_layout = False
        self._block_m: Optional[int] = None
        self._block_dtype = "auto"
        self._block_fit_cache = None      # (resolved_dtype, n_at_check)
        self._mut_since_fit = 0           # vectors changed since check
        self._pivot_cache = None
        #: seeds per query when entry_mode == "pivots"
        self.seed_width = 16
        #: pivot-count cap (subset scanned by the entry matmul). Large
        #: enough that clustered data keeps pivots in most clusters at
        #: 1M rows (~100-row clusters); the [B, D] x [D, 65536] entry
        #: matmul is a small share of a batched search on a GPU.
        self.max_pivots = 65536
        #: per-hop pool update: "bitonic" (sorted-pool merge network,
        #: core/search.py; chosen on other hardware, not re-measured on
        #: a GPU) or "sort" (full stable lax.sort)
        self.merge_strategy = "bitonic"
        #: Split device neighbor storage (layer 0 at full width, uppers
        #: at m) — halves upper-layer HBM; "auto" splits once the dense
        #: stack would exceed ~1 GB (4M-scale serving; smaller graphs
        #: keep the single-array layout that PartitionedGraph's stacker
        #: expects). True/False force it.
        self.split_layers: "bool | str" = "auto"
        #: LATENCY tier: batches up to this size are served by the
        #: native C++ engine on the HOST graph arrays — no jit dispatch,
        #: no device round trip (the Go reference answers one query in
        #: ~2.5 ms). The device path takes over where lockstep batching
        #: amortizes the dispatch. 0 disables the native tier.
        self.native_serve_max_batch = 32
        self._ef_calib: dict = {}     # (k, target) -> {ef, recall, n}
        self._ef_default: Optional[int] = None   # calibrate_ef override
        #: concurrency contract (graph.go:328 sync.RWMutex): mutations
        #: take the write side, searches the read side — concurrent
        #: searches run freely, a mutation excludes them.
        self._rw = RWLock()

    @property
    def ef_search(self) -> int:
        """Default search ef — ``cfg.ef_search`` unless ``calibrate_ef``
        installed a measured override (cfg is frozen by design)."""
        return self._ef_default if self._ef_default is not None \
            else self.cfg.ef_search

    @ef_search.setter
    def ef_search(self, ef: int) -> None:
        self._ef_default = int(ef)

    @property
    def block_layout(self) -> bool:
        """Materialize layer-0 neighbor-vector blocks (int8) in HBM:
        each hop gathers ONE contiguous [M0, D] block per expanded node
        instead of M0 scattered rows — row gathers are bound by the
        number of rows, not their bytes. Costs M0*D bytes/node extra
        HBM (DiskANN-style trade); built by one device-side gather,
        nothing extra is transferred from the host."""
        return self._block_layout

    @block_layout.setter
    def block_layout(self, on: bool) -> None:
        from hnsw_tpu.ops.distance import registered
        if on and registered(self.metric) is not None:
            raise ValueError(
                "block_layout unsupported for custom metrics")
        if bool(on) != self._block_layout:
            self._block_layout = bool(on)
            self._dirty = True

    @property
    def block_m(self) -> Optional[int]:
        """Narrow the serving neighbor blocks to the first block_m
        edges per row (HBM capacity knob; None = full rows). Changing
        it rebuilds the device graph on next use."""
        return self._block_m

    @block_m.setter
    def block_m(self, m: Optional[int]) -> None:
        m = None if m is None else int(m)
        if m != self._block_m:
            self._block_m = m
            self._dirty = True

    @property
    def block_dtype(self) -> str:
        """Neighbor-block element type: "int8" (1 byte, global scale —
        fast default for spread-out data), "float16" (2 bytes — needed
        on tightly clustered data, where within-cluster separations
        drown in int8 noise: measured 0.33 vs 0.99 recall at 1M
        clustered), or "auto" (sample-check which fits; default)."""
        return self._block_dtype

    @block_dtype.setter
    def block_dtype(self, dt: str) -> None:
        dt = canonical_dtype(dt, ("auto", "int8", "float16"),
                             "block_dtype")
        if dt != self._block_dtype:
            self._block_dtype = dt
            self._block_fit_cache = None
            self._dirty = True

    def _resolve_block_dtype(self, n: int) -> str:
        """Resolve "auto" once per data regime (re-checked when the
        index doubles/halves): the fit check costs ~1 s at scale and
        the distribution rarely changes between incremental syncs."""
        if self._block_dtype != "auto" or not self._block_layout:
            return self._block_dtype
        c = self._block_fit_cache
        if (c is not None and c[1] <= 2 * n and n <= 2 * c[1]
                and self._mut_since_fit <= 0.25 * c[1]):
            return c[0]
        from hnsw_tpu.core.state import _int8_block_fit
        used = self.slots.capacity_used
        fit = (_int8_block_fit(self.store.vectors[:used],
                               metric=self.metric) if used else 1.0)
        dt = "int8" if fit >= 0.9 else "float16"
        self._block_fit_cache = (dt, max(n, 1))
        self._mut_since_fit = 0
        return dt

    @property
    def entry_mode(self) -> str:
        """How searches enter layer 0.

        "descent" — classic HNSW upper-layer elevator (default).
        "pivots"  — one matmul over a ~N/16 pivot subset picks
          ``seed_width`` entry candidates per query, skipping the upper
          layers entirely. Coarse search: multiple entry basins
          (better recall on hard data) for one fused scan.
        """
        return self._entry_mode

    @entry_mode.setter
    def entry_mode(self, mode: str) -> None:
        if mode not in ("descent", "pivots"):
            raise ValueError(f"bad entry_mode {mode!r}")
        self._entry_mode = mode

    def _pivot_arrays(self):
        if self._pivot_cache is None:
            used = self.slots.capacity_used
            alive = np.flatnonzero(self.store.alive[:used])
            n_piv = int(min(self.max_pivots, max(1, len(alive) // 4)))
            stride = max(1, len(alive) // n_piv)
            sel = alive[::stride][:n_piv]
            self._pivot_cache = (
                jnp.asarray(sel.astype(np.int32)),
                jnp.asarray(self.store.vectors[sel], dtype=jnp.float32),
                jnp.asarray(self.store.sq_norms[sel]))
        return self._pivot_cache

    @property
    def hbm_mode(self) -> str:
        """HBM residency of the vector store.

        "full"      — f32 vectors in HBM (default).
        "float16"   — fp16 traversal store + exact f32 host rerank of
          the pool head. Half the HBM and half the row-gather bytes of
          "full", with enough mantissa (11 bits) to ROUTE through
          tightly clustered data where int8 misranks; the host rerank
          removes the residual fp16 head-ordering noise (measured:
          fp16 traversal alone costs ~7 recall points on tight
          clusters at ef=192 — the rerank restores f32 ordering).
        "quantized" — HBM holds ONLY the int8 traversal store (+ graph
          structure); raw vectors stay in ``self.store`` (RAM or an
          io.mmap_store.MmapVectorStore on disk) and the pool head is
          reranked on host. ~5x less HBM per vector — the unbounded-N
          graph-serving tier (reference: disk-backed searchLayer,
          parquet/graph.go:924-1076 + vector_ops.go:321-432).
        """
        return self._hbm_mode

    @hbm_mode.setter
    def hbm_mode(self, mode: str) -> None:
        mode = canonical_dtype(mode, ("full", "float16", "quantized"),
                               "hbm_mode")
        from hnsw_tpu.ops.distance import registered
        if mode != "full" and registered(self.metric) is not None:
            raise ValueError(
                f"hbm_mode={mode!r} unsupported for custom metrics "
                "(the host rerank scores built-in metrics only)")
        if mode != self._hbm_mode:
            self._hbm_mode = mode
            self._dirty = True

    # -- invariants (graph.go:916-937) ----------------------------------------
    def validate(self) -> None:
        self.cfg.validate()

    def __len__(self) -> int:
        return len(self.slots)

    def dims(self) -> int:
        return self.store.dim or 0

    # -- mutation ---------------------------------------------------------------
    @_writes
    def add(self, key: Hashable, vector) -> None:
        """Insert one node; replaces an existing node with the same key
        (graph.go:437's duplicate handling, using BatchAdd's correct
        inlined variant — SURVEY.md §7.4)."""
        vec = np.asarray(vector, np.float32)
        if key in self.slots:
            self.delete(key)
        slot, _ = self.slots.assign(key)
        self.store.put(slot, vec)
        self.host.insert_many([slot])
        self._mut_since_fit += 1
        self._dirty = True

    @_writes
    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        """Bulk insert (graph.go:942 BatchAdd semantics — sequential,
        duplicate keys replaced). For large batches prefer bulk_build."""
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        if len(set(keys)) != len(keys):
            # duplicate-in-batch: sequential last-wins (graph.go:1016-1023)
            for k, v in zip(keys, vectors):
                self.add(k, v)
            return
        for k in keys:
            if k in self.slots:
                self.delete(k)
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self.host.insert_many(slot_list)
        self._mut_since_fit += len(slot_list)
        self._dirty = True

    @_writes
    def build(self, keys: Sequence[Hashable], vectors,
              wave: int = 1024, method: str = "auto",
              quant_descent: bool = False,
              block_m: Optional[int] = None,
              descent_dtype: str = "float32",
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 128,
              abort_deadline: Optional[float] = None) -> None:
        """Bulk construction. Existing keys are replaced; duplicate keys
        within the batch are an error.

        method:
          "device" — wave-batched device builder (core/build_device)
          "host"   — native C++ sequential builder (hnsw_native.cpp)
          "auto"   — host up to 1M, device above (with the native
                     library present). The cut was set on other
                     hardware; the crossover on a GPU is not measured
                     yet. Both paths checkpoint/resume/abort.

        ``block_m`` narrows the quant-descent neighbor blocks to the
        first block_m edges per row (HBM knob for 2M+ single-device
        builds; None = full rows, auto-halved when full blocks would
        exceed ~5 GB).

        ``descent_dtype="float16"`` halves the device builder's HBM
        vector table and its descent gather bytes (the 16M+
        single-device knob; see core/build_device.bulk_insert_device).

        ``checkpoint_path`` makes a device build RESTARTABLE: every
        ``checkpoint_every`` waves the build syncs device state to the
        host arrays and atomically saves a full checkpoint — a crash
        loses at most checkpoint_every waves. Resume with
        ``Graph.resume_build(checkpoint_path, ...)``. Checkpoint cost
        at 8M, every 128 waves: ~1 GB neighbor D2H + one npz write.

        ``abort_deadline`` (absolute time.time()) bounds a device build
        by wall clock: past it, the build checkpoints and raises
        core.build_device.BuildDeadlineExceeded instead of running on —
        the graceful way to leave a device by a hard deadline with the
        work saved.
        """
        # canonical spelling (any sibling knob's alias accepted); an
        # unknown value must fail HERE, not fall through to a silent
        # full-f32 build that OOMs an hour into a 16M run
        descent_dtype = canonical_dtype(
            descent_dtype, ("float32", "float16"), "descent_dtype")
        if method not in ("auto", "host", "device"):
            raise ValueError(
                f"unknown build method {method!r}: auto|host|device")
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        key_set = set(keys)
        if len(key_set) != len(keys):
            raise ValueError("duplicate keys in build batch")
        # set-intersect ONCE instead of 8M per-key `in` probes, and
        # route fresh keys through SlotMap.assign_fresh_batch — the
        # per-key Python assign loop was the dominant host cost of an
        # 8M build on a slow core (~tens of minutes of dict calls).
        for k in (self.slots.key_to_slot.keys() & key_set):
            self.delete(k)
        slot_list = self.slots.assign_fresh_batch(list(keys))
        self.store.put_batch(slot_list, vectors)
        if method == "auto":
            from hnsw_tpu import native
            method = ("host" if native.available()
                      and len(keys) <= 1_000_000
                      else "device")
        if method == "host":
            # checkpoint/deadline parity with the device path: insert
            # in slices of checkpoint_every*wave nodes, snapshotting
            # between slices — a multi-minute native build (auto routes
            # host up to 1M now) is restartable via resume_build and
            # honors abort_deadline the same way
            sl = list(slot_list)
            step = (max(1, checkpoint_every) * max(1, wave)
                    if checkpoint_path is not None
                    or abort_deadline is not None else len(sl) or 1)
            for c0 in range(0, len(sl), step):
                self.host.insert_many(sl[c0:c0 + step])
                done_all = c0 + step >= len(sl)
                if not done_all:
                    import time as _time

                    from hnsw_tpu.core.build_device import \
                        BuildDeadlineExceeded
                    if checkpoint_path is not None:
                        from hnsw_tpu.io.codec import save_graph
                        self._dirty = True
                        save_graph(self, checkpoint_path)
                    if (abort_deadline is not None
                            and _time.time() >= abort_deadline):
                        hint = ("; resume with Graph.resume_build"
                                if checkpoint_path is not None else
                                " (no checkpoint_path: not resumable)")
                        err = BuildDeadlineExceeded(
                            f"host build deadline: {c0 + step}/{len(sl)}"
                            f" inserted{hint}")
                        err.graph = self   # servable partial prefix
                        raise err
        else:
            from hnsw_tpu.core.build_device import (BuildDeadlineExceeded,
                                                    bulk_insert_device)
            on_ckpt = None
            if checkpoint_path is not None:
                from hnsw_tpu.io.codec import save_graph

                def on_ckpt(done, _p=checkpoint_path):
                    save_graph(self, _p)
                on_ckpt.checkpoint_path = checkpoint_path
            try:
                bulk_insert_device(self.host, slot_list, wave=wave,
                                   quant_descent=quant_descent,
                                   block_m=block_m,
                                   descent_dtype=descent_dtype,
                                   on_checkpoint=on_ckpt,
                                   checkpoint_every=checkpoint_every,
                                   abort_deadline=abort_deadline)
            except BuildDeadlineExceeded as e:
                # host arrays were synced (and the checkpoint written)
                # before the raise — the caller can still SERVE the
                # inserted prefix this round instead of only resuming
                # next round (mask_pending_for_serve below)
                e.graph = self
                raise
        if checkpoint_path is not None:
            # final, complete — written for the HOST path too (a
            # minutes-scale native build still honors the contract that
            # resume_build(checkpoint_path) finds a loadable graph)
            from hnsw_tpu.io.codec import save_graph
            save_graph(self, checkpoint_path)
        self._block_fit_cache = None   # bulk data change: re-check fit
        self._mut_since_fit = 0
        self._dirty = True

    @classmethod
    def resume_build(cls, checkpoint_path: str,
                     wave: int = 1024,
                     method: str = "device",
                     quant_descent: bool = False,
                     block_m: Optional[int] = None,
                     descent_dtype: str = "float32",
                     checkpoint_every: int = 128,
                     abort_deadline: Optional[float] = None) -> "Graph":
        """Resume a crashed/killed ``build(checkpoint_path=...)``.

        The checkpoint stores every assigned key + vector; nodes the
        build had not yet inserted are exactly those with level < 0.
        Loads the snapshot, inserts the pending slots only (fresh level
        sampling — same geometric law), and keeps checkpointing to the
        same path. ``method`` follows build(): "device" (default; the
        multi-hour 1M+ regime this exists for), "host" (native
        sequential), or "auto" (host while pending <= 1M).  Returns
        the completed Graph. A finished checkpoint simply loads and
        returns.
        """
        if method not in ("auto", "host", "device"):
            raise ValueError(
                f"unknown build method {method!r}: auto|host|device")
        from hnsw_tpu.io.codec import load_graph
        g = load_graph(checkpoint_path)
        host = g.host
        assigned = np.fromiter(g.slots.key_to_slot.values(), np.int64,
                               len(g.slots.key_to_slot))
        pending = np.sort(assigned[host.levels[assigned] < 0])
        if len(pending):
            from hnsw_tpu.io.codec import save_graph
            if method == "auto":
                from hnsw_tpu import native
                method = ("host" if native.available()
                          and len(pending) <= 1_000_000 else "device")
            if method == "host":
                from hnsw_tpu.core.build_device import \
                    BuildDeadlineExceeded
                step = max(1, checkpoint_every) * max(1, wave)
                pl = list(pending)
                for c0 in range(0, len(pl), step):
                    host.insert_many(pl[c0:c0 + step])
                    if c0 + step < len(pl):
                        g._dirty = True
                        save_graph(g, checkpoint_path)
                        import time as _time
                        if (abort_deadline is not None
                                and _time.time() >= abort_deadline):
                            err = BuildDeadlineExceeded(
                                f"host resume deadline: "
                                f"{c0 + step}/{len(pl)} inserted")
                            err.graph = g
                            raise err
            else:
                from hnsw_tpu.core.build_device import (
                    BuildDeadlineExceeded, bulk_insert_device)

                def on_ckpt(done, _p=checkpoint_path):
                    save_graph(g, _p)
                on_ckpt.checkpoint_path = checkpoint_path
                try:
                    bulk_insert_device(host, pending, wave=wave,
                                       quant_descent=quant_descent,
                                       block_m=block_m,
                                       descent_dtype=descent_dtype,
                                       on_checkpoint=on_ckpt,
                                       checkpoint_every=checkpoint_every,
                                       abort_deadline=abort_deadline)
                except BuildDeadlineExceeded as e:
                    e.graph = g   # servable partial prefix (see build)
                    raise
            save_graph(g, checkpoint_path)
            g._block_fit_cache = None
            g._mut_since_fit = 0
            g._dirty = True
        return g

    def mask_pending_for_serve(self) -> int:
        """Make a deadline-aborted build's inserted PREFIX servable.

        A bulk build assigns every key a slot (and stores its vector)
        up front; ``BuildDeadlineExceeded`` leaves the never-inserted
        tail marked ``level < 0`` with no in-edges — graph traversal
        cannot reach it, but the exact/GT tiers scan ``store.alive``,
        which batch_add set True at slot assignment. Tombstone that
        tail IN MEMORY ONLY (the on-disk checkpoint keeps its level<0
        markers, so ``Graph.resume_build`` can still finish later) and
        return the servable node count. Reference parity: the Go
        builder has no aborted-bulk-serve notion — this exists for the
        deadline-bounded multi-hour device builds
        (/root/reference/hnsw-extensions/parquet/graph.go:25 regime).
        """
        cap = min(len(self.store.alive) if self.store.alive is not None
                  else 0, len(self.host.levels))
        if cap:
            pending = self.host.levels[:cap] < 0
            if pending.any():
                self.store.alive[:cap] &= ~pending
                self._dirty = True
        return int(self.store.alive[:cap].sum()) if cap else 0

    @_writes
    def refine(self, wave: int = 2048, slots=None,
               local: bool = False) -> None:
        """Second-pass edge refinement against the final graph —
        recovers the recall that batched wave construction loses on
        early nodes (core/build_device.refine_device). ``slots`` scopes
        the pass (post-delete repair); a scoped pass buckets the wave to
        the affected-set size (pow2, min 256) so a 100-node repair does
        not pay a 2048-wide construction descent — pow2 buckets keep the
        compiled-shape count bounded (ROADMAP: fixed-size refine waves).
        """
        from hnsw_tpu.core.build_device import refine_device
        from hnsw_tpu.core.state import bucket_pow2
        if slots is not None and len(slots):
            wave = min(wave, bucket_pow2(len(slots), 256))
        refine_device(self.host, wave=wave, slots=slots, local=local)
        self._dirty = True

    @_writes
    def delete(self, key: Hashable) -> bool:
        """Remove a node and repair its neighborhood
        (graph.go:843 Delete + isolate/replenish)."""
        slot = self.slots.slot_of(key)
        if slot is None:
            return False
        self.host.delete_many([slot])
        self.store.kill(slot)
        self.slots.release(key)
        self._mut_since_fit += 1
        self._dirty = True
        return True

    @_writes
    def batch_delete(self, keys: Sequence[Hashable],
                     refine: bool = False) -> List[bool]:
        """graph.go:869 BatchDelete: per-key success flags; one
        vectorized in-edge sweep + repair pass for the whole batch.

        ``refine=True`` additionally re-runs the construction descent
        for the neighborhoods the deletes touched (in-edge owners),
        recovering the recall that replenish-only repair loses on
        delete-heavy workloads."""
        oks, slots = [], []
        for k in keys:
            s = self.slots.slot_of(k)
            if s is None:
                oks.append(False)
                continue
            oks.append(True)
            slots.append(s)
            self.store.kill(s)
            self.slots.release(k)
        if slots:
            affected = None
            if refine:
                dslots = np.asarray(slots, np.int64)
                touched = np.isin(self.host.neighbors, dslots).any(
                    axis=(0, 2))
                touched[dslots[dslots < len(touched)]] = False
                affected = np.flatnonzero(touched)
            self.host.delete_many(slots)
            self._mut_since_fit += len(slots)
            self._dirty = True
            if refine and affected is not None and len(affected):
                # local (seeded-beam, layer-0-only) repair: same recall
                # recovery as the full descent, one short beam per wave
                self.refine(slots=affected, local=True)
        return oks

    @_reads
    def lookup(self, key: Hashable) -> Optional[np.ndarray]:
        """O(1) vector fetch (graph.go:898 Lookup)."""
        s = self.slots.slot_of(key)
        return None if s is None else np.array(self.store.get(s))

    # -- device sync --------------------------------------------------------------
    @_reads
    def device_graph(self) -> DeviceGraph:
        if self._dirty or self._dev is None:
            self._pivot_cache = None
            n = self.slots.capacity_used
            cap = bucket_pow2(max(n, 1), 8)
            nb, levels, entry, top = self.host.arrays()
            hcap = nb.shape[1]
            use = min(hcap, cap)
            import ml_dtypes
            sd = {"bfloat16": ml_dtypes.bfloat16,
                  "float16": np.float16}.get(self.cfg.store_dtype,
                                             np.float32)
            if self._hbm_mode == "float16":
                sd = np.float16
            vecs = (self.store.vectors[:use]
                    if self.store.vectors is not None
                    else np.zeros((0, 1), np.float32))
            sqs = (self.store.sq_norms[:use]
                   if self.store.sq_norms is not None
                   else np.zeros((0,), np.float32))
            if self.metric == "cosine" and vecs.size:
                # pre-normalized store: cosine distances are invariant,
                # and hops skip the per-candidate norm gather entirely
                vecs = vecs / np.sqrt(np.maximum(sqs, 1e-30))[:, None]
                sqs = np.ones_like(sqs)
            split = self.split_layers
            if split == "auto":
                # compact jagged uppers: ~N/3 rows total instead of
                # (L-1) * cap — the 8M+ serving enabler (5.9 GB -> 0.2
                # GB at 8M). One extra [B, E] map gather per upper hop.
                dense_bytes = nb.shape[0] * cap * nb.shape[2] * 4
                split = "compact" if dense_bytes > (1 << 30) else False
            self._dev = from_host(
                vecs,
                sqs,
                nb[:, :use],
                levels[:use],
                (self.store.alive[:use] if self.store.alive is not None
                 else np.zeros((0,), bool)),
                entry, cap_pad=cap, store_dtype=sd,
                quantize=self._hbm_mode == "quantized",
                hbm_vectors=self._hbm_mode != "quantized",
                block_layout=self._block_layout,
                block_m=self.block_m,
                block_dtype=self._resolve_block_dtype(n),
                metric=self.metric,
                split_layers=split,
                upper_m=self.cfg.m)
            self._dirty = False
        return self._dev

    def _attach_device(self, dev: DeviceGraph) -> None:
        """Install a device graph produced by the bulk builder."""
        self._dev = dev
        self._dirty = False

    # -- search ------------------------------------------------------------------
    @_reads
    def batch_search_slots(self, queries: np.ndarray, k: int,
                           ef: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(self.slots) == 0:
            q = queries.shape[0]
            return (np.full((q, k), INF_DIST, np.float32),
                    np.full((q, k), -1, np.int64))
        self.store.ensure_dim(queries.shape[-1])
        ef = ef if ef is not None else self.ef_search
        if 0 < queries.shape[0] <= self.native_serve_max_batch:
            res = self._native_search(queries, k, ef)
            if res is not None:
                return res
        g = self.device_graph()
        nq = queries.shape[0]
        q_pad = _bucket(nq)
        if q_pad != nq:
            queries = np.pad(queries, ((0, q_pad - nq), (0, 0)))
        pool = max(ef, k)
        expand = self.cfg.search_expand
        hops = max(self.cfg.max_hops, -(-2 * pool // expand))
        seed_ids = None
        if self._entry_mode == "pivots":
            from hnsw_tpu.core.search import pivot_seeds
            pids, pvecs, psq = self._pivot_arrays()
            seed_ids = pivot_seeds(jnp.asarray(queries), pvecs, psq, pids,
                                   s=min(self.seed_width, pool),
                                   metric=self.metric,
                                   fast_math=self.fast_math)
        if self._hbm_mode in ("quantized", "float16"):
            # traversal-ordered pool head off device; exact rerank on
            # host against the (possibly disk-resident) store
            R = min(max(2 * k, 32), max(pool, k))
            _, i = search_graph(g, jnp.asarray(queries), k=R, ef=ef,
                                metric=self.metric, max_hops=hops,
                                expand=expand, fast_math=self.fast_math,
                                device_rerank=False, seed_ids=seed_ids,
                                merge=self.merge_strategy,
                                store_normalized=self.metric == "cosine")
            return self._host_rerank(queries[:nq], np.asarray(i[:nq]), k)
        d, i = search_graph(g, jnp.asarray(queries), k=k, ef=ef,
                            metric=self.metric, max_hops=hops,
                            expand=expand, fast_math=self.fast_math,
                            seed_ids=seed_ids, merge=self.merge_strategy,
                            store_normalized=self.metric == "cosine")
        return np.asarray(d[:nq]), np.asarray(i[:nq], np.int64)

    def _pivot_slots_host(self) -> np.ndarray:
        """Host-side pivot subset for the native engine's seeded entry:
        ~4*sqrt(N) stride-sampled live slots (the C++ engine scans them
        with SIMD dots, so the budget is ~sqrt(N) — the device variant
        can afford N/4). Cached on a (capacity, mutations) stamp."""
        stamp = (self.slots.capacity_used, self._mut_since_fit)
        c = getattr(self, "_pivot_host_cache", None)
        if c is not None and c[0] == stamp:
            return c[1]
        used = stamp[0]
        alive = np.flatnonzero(self.store.alive[:used])
        n_piv = int(min(1024, max(16, 4.0 * np.sqrt(max(len(alive), 1)))))
        stride = max(1, len(alive) // n_piv)
        sel = np.ascontiguousarray(alive[::stride][:n_piv], np.int64)
        self._pivot_host_cache = (stamp, sel)
        return sel

    def _native_search(self, queries: np.ndarray, k: int, ef: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Serve a small batch from the native C++ engine
        (native/hnsw_native.cpp hnsw_search_batch) over the
        authoritative HOST graph arrays — the sub-millisecond
        single-query path (reference anchor: adaptive hybrid 2.51 ms/q,
        hybrid/README.md:650; parquet single search 128 us,
        parquet/README.md:69). Same HNSW semantics as the device path
        (the C++ engine is the build-parity oracle); tombstones are
        skipped via levels<0 and pruned edges. entry_mode="pivots"
        carries over: the engine seeds the layer-0 beam from a SIMD
        pivot scan instead of the upper-layer descent. Returns None
        when the library or metric is unsupported — callers fall
        through to the device path."""
        from hnsw_tpu import native
        pivots = None
        if self._entry_mode == "pivots":
            pivots = self._pivot_slots_host()
        res = native.search_batch(self.host, queries, k, ef,
                                  pivots=pivots,
                                  n_seed=min(self.seed_width, 8))
        if res is None:
            return None
        d, i = res
        return d.astype(np.float32, copy=False), \
            i.astype(np.int64, copy=False)

    def _host_rerank(self, queries: np.ndarray, cand: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact f32 rerank of per-query candidate slots against the
        host/disk store (one batched fetch — the GetVectorsBatch role,
        parquet/vector_ops.go:321-432)."""
        from hnsw_tpu.utils.rerank import host_rerank
        return host_rerank(self.store, self.metric, queries, cand, k)

    @_reads
    def batch_search(self, queries, k: int, ef: Optional[int] = None
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """graph.go:1047 BatchSearch: (keys [Q][k], dists [Q,k])."""
        d, i = self.batch_search_slots(queries, k, ef)
        keys = [self.slots.keys_for(row) for row in i]
        return keys, d

    def _host_oracle_slots(self, queries: np.ndarray, k: int,
                           chunk: int = 1 << 20
                           ) -> np.ndarray:
        """Exact top-k SLOT ids for ``queries`` via a chunked host BLAS
        scan of the live store — the calibration ground truth. Host-side
        so it works in every mode (hbm_mode="quantized" keeps only a
        placeholder on device; disk stores page in per chunk)."""
        cap = self.slots.capacity_used
        alive = self.store.alive[:cap]
        live = np.flatnonzero(alive)
        qf = np.atleast_2d(np.asarray(queries, np.float32))
        q_sq = np.sum(qf * qf, axis=-1)
        best_d = [np.empty((qf.shape[0], 0), np.float32)]
        best_i = [np.empty((qf.shape[0], 0), np.int64)]
        for lo in range(0, len(live), chunk):
            sl = live[lo:lo + chunk]
            rows = self.store.get_batch(sl).astype(np.float32)
            qv = qf @ rows.T
            c_sq = self.store.sq_norms[sl]
            d = np_gram_epilogue(qv, q_sq[:, None], c_sq[None, :],
                                 self.metric)
            kk = min(k, d.shape[1])
            part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
            best_d.append(np.take_along_axis(d, part, axis=1))
            best_i.append(sl[part])
        d_all = np.concatenate(best_d, axis=1)
        i_all = np.concatenate(best_i, axis=1)
        kk = min(k, d_all.shape[1])
        part = np.argpartition(d_all, kk - 1, axis=1)[:, :kk]
        return np.take_along_axis(i_all, part, axis=1)

    @_reads
    def calibrate_ef(self, target_recall: float, k: int = 10,
                     sample: int = 64, seed: int = 0,
                     ladder: Sequence[int] = (20, 40, 64, 96, 128, 192,
                                              256, 384, 512, 768, 1024),
                     probe_queries=None) -> Tuple[int, float]:
        """Self-tuning ef: install the smallest ``ef`` whose measured
        recall@k against an exact oracle meets ``target_recall`` as the
        graph's default ``ef_search``, and return
        ``(ef, measured_recall)``.

        Standalone-graph counterpart of ``HybridIndex.calibrate`` (which
        routes across tiers; here the tier is fixed and only ef moves) —
        the ef-autoscale policy from ROADMAP item 4: ef must grow with N
        on unstructured data, and a fixed default silently under-serves.
        Pass ``probe_queries`` (a sample of the REAL workload) whenever
        you have one: synthesized probes are OFF-node (0.85/0.15 member
        mix — raw member probes anchor their own basin) but still sit
        near the data manifold, so they under-provision adversarial
        workloads (measured: a 0.9 member-mix calibration picked ef=20
        and served fully-random 10k x 128 queries at 0.45; calibrating
        on 64 real queries tracks the target).
        Cached per (k, target) — skipped when ``probe_queries`` is
        given; re-measured when the graph grows or shrinks by >25%.  If no ladder rung meets the target, the
        best-measured rung is installed (cheapest on recall ties) and
        its recall returned — callers
        wanting a hard contract should route via
        ``HybridIndex.search(target_recall=...)`` which can fall back
        to the exact tier.
        """
        if not ladder:
            raise ValueError("ladder must be non-empty")
        key = (int(k), round(float(target_recall), 3))
        n_now = len(self)
        cached = self._ef_calib.get(key)
        if probe_queries is None and cached is not None \
                and cached["n"] > 0 \
                and abs(n_now - cached["n"]) <= 0.25 * cached["n"]:
            self.ef_search = cached["ef"]
            return cached["ef"], cached["recall"]
        cap = self.slots.capacity_used
        live = np.flatnonzero(self.store.alive[:cap])
        if len(live) == 0:
            return self.ef_search, 1.0
        rng = np.random.default_rng(seed)
        if probe_queries is not None:
            queries = np.atleast_2d(
                np.asarray(probe_queries, np.float32))[:sample]
        else:
            probe = rng.choice(live, size=min(sample, len(live)),
                               replace=False)
            mix = rng.choice(live, size=len(probe))
            bad = mix == probe
            if bad.any() and len(live) > 1:
                pos = {int(v): i for i, v in enumerate(live)}
                mix[bad] = live[(np.array([pos[int(v)]
                                           for v in probe[bad]]) + 1)
                                % len(live)]
            queries = (0.85 * self.store.get_batch(probe)
                       .astype(np.float32)
                       + 0.15 * self.store.get_batch(mix)
                       .astype(np.float32))
        gt = self._host_oracle_slots(queries, k)
        gts = [set(map(int, row)) for row in gt]
        total = sum(len(s) for s in gts) or 1
        best_ef, best_rec = None, -1.0
        for ef in sorted({max(int(e), k) for e in ladder}):
            _, ii = self.batch_search_slots(queries, k, ef=ef)
            hits = sum(len({int(s) for s in row if s >= 0} & gts[qi])
                       for qi, row in enumerate(ii))
            rec = hits / total
            if rec > best_rec:
                best_ef, best_rec = ef, rec
            if rec >= target_recall:
                best_ef, best_rec = ef, rec
                break
        self._ef_calib[key] = {"ef": best_ef, "recall": best_rec,
                               "n": n_now}
        self.ef_search = best_ef
        return best_ef, best_rec

    def calibration_state(self) -> dict:
        """JSON-able snapshot of calibrate_ef's results (and the
        installed default), persisted through io.codec checkpoints and
        DiskGraph metadata so a reopened large index does not re-pay
        the host oracle scan (minutes at 8M on one host core).
        Entries carry the index size they were
        measured at; calibrate_ef's >25%-drift check re-measures stale
        ones automatically after restore."""
        return {
            "ef_calib": [[kk, tt, c["ef"], c["recall"], c["n"]]
                         for (kk, tt), c in self._ef_calib.items()],
            "ef_default": self._ef_default,
        }

    def restore_calibration(self, state: Optional[dict]) -> None:
        """Inverse of calibration_state (no-op on None/empty)."""
        if not state:
            return
        for kk, tt, ef, rec, n in state.get("ef_calib", []):
            self._ef_calib[(int(kk), round(float(tt), 3))] = {
                "ef": int(ef), "recall": float(rec), "n": int(n)}
        if state.get("ef_default") is not None:
            self._ef_default = int(state["ef_default"])

    @_reads
    def search(self, query, k: int, ef: Optional[int] = None
               ) -> List[Tuple[Any, float]]:
        """graph.go:534 Search: [(key, dist)] best-first."""
        d, i = self.batch_search_slots(np.asarray(query, np.float32)[None],
                                       k, ef)
        return [(self.slots.key_of(int(s)), float(dd))
                for dd, s in zip(d[0], i[0]) if s >= 0]

    # -- negative-example search (graph.go:1116-1377) --------------------------------
    def _rescore_negative(self, cand_slots: np.ndarray,
                          cand_dists: np.ndarray, query: np.ndarray,
                          negatives: np.ndarray, k: int,
                          neg_weight: float) -> List[Tuple[Any, float]]:
        """Over-fetched candidates -> combined score -> top-k.

        score = (1 - d_query) - neg_weight * avg(1 - d_neg), with the
        reference's special cases (exact match -> 2.0; any negative
        within 0.1 -> strong penalty). graph.go:1299-1353, minus the
        key-specific test boost (deliberately omitted)."""
        valid = cand_slots >= 0
        slots = cand_slots[valid]
        if len(slots) == 0:
            return []
        vecs = self.store.vectors[slots]
        qd = np_pairwise_dist(query[None], vecs, self.metric)[0]
        nd = np_pairwise_dist(negatives, vecs, self.metric)  # [Nneg, C]
        q_sim = 1.0 - qd
        neg_sim = 1.0 - nd
        avg_neg_sim = neg_sim.mean(axis=0)
        very_close = (nd < 0.1).any(axis=0)
        score = q_sim - neg_weight * avg_neg_sim
        score = np.where(very_close, q_sim - neg_weight * 2.0, score)
        score = np.where(qd < 0.001, 2.0, score)
        order = np.argsort(-score, kind="stable")[:k]
        return [(self.slots.key_of(int(slots[o])), float(score[o]))
                for o in order]

    @_reads
    def search_with_negative(self, query, negative, k: int,
                             neg_weight: float = 0.5
                             ) -> List[Tuple[Any, float]]:
        return self.search_with_negatives(query, [negative], k, neg_weight)

    @_reads
    def search_with_negatives(self, query, negatives, k: int,
                              neg_weight: float = 0.5
                              ) -> List[Tuple[Any, float]]:
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        if not (0.0 <= neg_weight <= 1.0):
            raise ValueError(
                f"negWeight must be between 0.0 and 1.0, got {neg_weight}")
        query = np.asarray(query, np.float32)
        negatives = np.atleast_2d(np.asarray(negatives, np.float32))
        if negatives.shape[0] == 0:
            return self.search(query, k)
        if len(self.slots) == 0:
            return []
        if self.store.dim is not None and negatives.shape[1] != self.store.dim:
            raise ValueError(
                f"negative embedding dimension mismatch: "
                f"{self.store.dim} != {negatives.shape[1]}")
        expanded_k = max(3 * k, 10)  # graph.go:1149-1152
        d, i = self.batch_search_slots(query[None], expanded_k)
        return self._rescore_negative(i[0], d[0], query, negatives, k,
                                      neg_weight)

    @_reads
    def batch_search_with_negatives(self, queries, negatives_per_query,
                                    k: int, neg_weight: float = 0.5
                                    ) -> List[List[Tuple[Any, float]]]:
        """graph.go:1382 BatchSearchWithNegatives — one device sweep for
        the over-fetch, host re-scoring per query."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(negatives_per_query) != queries.shape[0]:
            raise ValueError("negatives list length must match queries")
        if len(self.slots) == 0:
            return [[] for _ in range(queries.shape[0])]
        expanded_k = max(3 * k, 10)
        d, i = self.batch_search_slots(queries, expanded_k)
        out = []
        for qi in range(queries.shape[0]):
            negs = np.atleast_2d(np.asarray(negatives_per_query[qi],
                                            np.float32))
            if negs.size == 0:
                out.append([(self.slots.key_of(int(s)), float(dd))
                            for dd, s in zip(d[qi][:k], i[qi][:k]) if s >= 0])
            else:
                out.append(self._rescore_negative(i[qi], d[qi], queries[qi],
                                                  negs, k, neg_weight))
        return out

    @_reads
    def parallel_search(self, query, k: int, num_workers: int = 0,
                        ef: Optional[int] = None
                        ) -> List[Tuple[Any, float]]:
        """API parity with graph.go:631 ParallelSearch. On the device
        the batched lockstep search IS the parallel path (SURVEY.md §2.7);
        ``num_workers`` is accepted and ignored."""
        del num_workers
        return self.search(query, k, ef)

    # -- misc ----------------------------------------------------------------------
    def keys(self) -> List[Any]:
        return list(self.slots.key_to_slot.keys())

    @property
    def num_layers(self) -> int:
        return self.host.top + 1
