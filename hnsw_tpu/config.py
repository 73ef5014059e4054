"""Configuration dataclasses for hnsw_tpu.

Defaults mirror the reference library for capability parity
(reference: graph.go:340-348 — M=16, Ml=0.25, EfSearch=20, cosine).
All configs are plain dataclasses with explicit ``validate()`` methods,
matching the reference idiom of config structs + ``Validate()``
(reference: graph.go:916-937, hybrid/hybrid.go:85-122).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Supported metrics. "cosine" and "l2" ("euclidean") match the reference
#: registry (reference: distance.go:25-28); "sqeuclidean" and "dot" are
#: matmul-friendly extras (monotone transforms / inner-product search).
METRICS = ("cosine", "l2", "euclidean", "sqeuclidean", "dot")


def canonical_metric(name: str) -> str:
    """Canonicalize a builtin metric name, or pass through a registered
    custom distance name (reference: pluggable DistanceFunc,
    distance.go:12 + RegisterDistanceFunc distance.go:44)."""
    n = name.lower()
    if n == "euclidean":
        return "l2"
    if n in METRICS:
        return n
    # registered custom metric? (deferred import: ops.distance imports us)
    from hnsw_tpu.ops.distance import registered
    if registered(name) is not None:
        return name
    raise ValueError(
        f"unknown metric {name!r}; supported: {METRICS} or a name "
        f"registered via hnsw_tpu.register_distance()")


#: spelling -> canonical class for every precision knob in the package
_DTYPE_CANON = {
    "bf16": "bf16", "bfloat16": "bf16",
    "fp16": "fp16", "float16": "fp16", "half": "fp16",
    "f32": "float32", "fp32": "float32", "float32": "float32",
}


def canonical_dtype(value, allowed, knob: str = "dtype") -> str:
    """Resolve a precision-knob spelling to the knob's own vocabulary.

    The package grew several precision knobs (ExactIndex.hbm_dtype,
    StreamingExactIndex.stream_dtype, GraphConfig.store_dtype,
    Graph.hbm_mode, Graph.build(descent_dtype=...)) whose internal
    vocabularies spell the same dtypes differently ("bf16" vs
    "bfloat16", "fp16" vs "float16"). Every knob routes through here,
    so ANY spelling a sibling knob accepts resolves at all of them —
    returned as the entry of ``allowed`` in the same alias class.
    Non-dtype mode words ("auto", "full", "quantized", "int8") pass
    through when listed in ``allowed``.
    """
    v = str(value).lower()
    cv = _DTYPE_CANON.get(v, v)
    for a in allowed:
        if _DTYPE_CANON.get(a, a) == cv:
            return a
    raise ValueError(
        f"{knob} must be one of {tuple(allowed)} (dtype aliases "
        f"bf16/bfloat16, fp16/float16/half, f32/fp32/float32 are "
        f"accepted); got {value!r}")


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """HNSW graph hyper-parameters.

    Mirrors reference ``Graph`` fields (graph.go:305-332) with the same
    defaults (graph.go:340-348).
    """

    m: int = 16            # max neighbors per node per layer (graph.go:316)
    ml: float = 0.25       # level generation factor (graph.go:320)
    ef_search: int = 20    # search beam width (graph.go:325)
    #: construction-time beam width. The reference reuses EfSearch for
    #: insert searches (graph.go:500), which caps graph quality hard on
    #: unstructured data; a dedicated (larger) construction beam is the
    #: standard HNSW design and a deliberate improvement.
    ef_construction: int = 100
    #: base-layer max degree. The reference uses M on every layer
    #: (graph.go:316); the standard HNSW convention (and measurably
    #: better recall on high-dim data) is 2*M at layer 0. None = 2*m.
    m0: Optional[int] = None
    #: apply the neighbor-diversity heuristic (Malkov Alg. 4: keep a
    #: candidate only if it is closer to the query than to any already
    #: -selected neighbor, then backfill with pruned candidates) when
    #: selecting edges during bulk build. The reference keeps plain
    #: closest-M (graph.go:41-81), which degrades recall sharply on
    #: unstructured high-dim data.
    diversify: bool = True
    #: also apply the diversity heuristic when RE-selecting rows hit by
    #: reverse edges in the device builder (forward rows always follow
    #: ``diversify``). Off by default: measured recall delta vs
    #: closest-deg is nil at 10k while the heuristic adds an extra
    #: [chunk, C, C] pairwise gram per reverse-update chunk.
    reverse_diversify: bool = False

    @property
    def m_base(self) -> int:
        return self.m0 if self.m0 is not None else 2 * self.m

    def max_degree(self, layer: int) -> int:
        return self.m_base if layer == 0 else self.m
    metric: str = "cosine"
    seed: int = 0          # level-sampling RNG seed (graph.go:312 Rng)
    #: max beam-search hops per layer; static bound required by XLA.
    #: The reference terminates on "no improvement" (graph.go:164-166);
    #: we run a masked while_loop with this upper bound as a safety net.
    #: Effective bound scales with pool size: max(max_hops, 2*pool/expand).
    max_hops: int = 128
    #: pool entries expanded per hop in batched beam search. >1 trades a
    #: few extra distance evals for proportionally fewer (fatter) hops —
    #: the right trade on matrix units.
    search_expand: int = 4
    #: dtype for on-device vector storage: "float32" (default),
    #: "float16" (graph-tier capacity mode — halves HBM AND the
    #: row-gather bytes of the traversal hop; 11 mantissa bits rank
    #: tightly clustered data where int8/bfloat16 fail, the same
    #: physics as the fp16 neighbor-block finding), or "bfloat16"
    #: (spread-out data only). Norms stay f32 from the host store, so
    #: only the vector components round.
    store_dtype: str = "float32"

    def validate(self) -> None:
        # Mirrors reference Graph.Validate (graph.go:916-937).
        if self.m <= 0:
            raise ValueError(f"m must be greater than 0, got {self.m}")
        if not (0.0 < self.ml <= 1.0):
            raise ValueError(f"ml must be in (0, 1], got {self.ml}")
        if self.ef_search <= 0:
            raise ValueError(
                f"ef_search must be greater than 0, got {self.ef_search}")
        if self.ef_construction <= 0:
            raise ValueError(
                f"ef_construction must be greater than 0, "
                f"got {self.ef_construction}")
        if self.m0 is not None and self.m0 < self.m:
            raise ValueError(f"m0 ({self.m0}) must be >= m ({self.m})")
        canonical_metric(self.metric)
        # normalize in place (frozen dataclass): consumers key dicts on
        # the canonical spelling, so "bf16"-style aliases must resolve
        # here, not just pass a membership check
        object.__setattr__(self, "store_dtype", canonical_dtype(
            self.store_dtype, ("float32", "float16", "bfloat16"),
            "store_dtype"))

    def replace(self, **kw) -> "GraphConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Hybrid index configuration.

    Mirrors reference ``IndexConfig`` defaults (hybrid/hybrid.go:85-122).
    """

    exact_threshold: int = 1000
    m: int = 16
    ml: float = 0.25
    ef_search: int = 20
    metric: str = "cosine"
    num_hash_tables: int = 4
    num_hash_bits: int = 8
    num_partitions: int = 10
    partition_size: int = 10000
    seed: int = 42  # reference LSH/partitioner use fixed seed 42 (lsh.go:64)
    #: strategy for the very-large tier: "ivf" (device partition scans;
    #: auto-nprobe serves recall 1.0 on random 10k, where a fixed LSH
    #: bucket union is unvalidated at scale) or "lsh" (reference
    #: parity, hybrid.go:358).
    large_strategy: str = "ivf"
    #: partitions probed per IVF query: an int, or "auto" (default) —
    #: IVFIndex calibrates the smallest nprobe meeting its recall floor
    #: against a sampled exact oracle (a fixed 8 silently served recall
    #: 0.51 on random 10k).
    ivf_nprobe: "int | str" = "auto"
    #: serve the exact tier with the bf16 scan + widened top-k + f32
    #: rerank (recall >= 0.99 vs the f32 oracle). False keeps the exact
    #: tier exact.
    fast_exact: bool = False
    #: exact-tier HBM table precision: "float32" (default), the
    #: capacity modes "bf16" / "fp16" / "int8" (reduced-precision scan
    #: + f32 host rerank; 2/2/1 bytes per component — index/exact.py;
    #: fp16 = bf16's bytes with 8x the mantissa, for
    #: tight clusters), or "auto" (fidelity-ladder check picks the
    #: smallest rung that can rank the data).
    exact_hbm_dtype: str = "float32"

    def validate(self) -> None:
        if self.exact_threshold < 0:
            raise ValueError("exact_threshold must be >= 0")
        if self.num_hash_tables <= 0 or self.num_hash_bits <= 0:
            raise ValueError("hash table params must be > 0")
        if self.num_hash_bits > 30:
            raise ValueError("num_hash_bits must be <= 30 (int32 packing)")
        if self.num_partitions <= 0 or self.partition_size <= 0:
            raise ValueError("partition params must be > 0")
        if self.large_strategy not in ("lsh", "ivf"):
            raise ValueError(f"bad large_strategy {self.large_strategy}")
        if isinstance(self.ivf_nprobe, str):
            if self.ivf_nprobe != "auto":
                raise ValueError(f"bad ivf_nprobe {self.ivf_nprobe!r}")
        elif self.ivf_nprobe <= 0:
            raise ValueError("ivf_nprobe must be > 0 or 'auto'")
        object.__setattr__(self, "exact_hbm_dtype", canonical_dtype(
            self.exact_hbm_dtype,
            ("float32", "bf16", "fp16", "int8", "auto"),
            "exact_hbm_dtype"))
        canonical_metric(self.metric)


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Adaptive strategy-selector configuration.

    Mirrors reference ``AdaptiveConfig`` defaults (hybrid/adaptive.go:73-85).
    """

    window_size: int = 100
    latency_weight: float = 0.6
    recall_weight: float = 0.3
    success_rate_weight: float = 0.1
    learning_rate: float = 0.05
    initial_exact_threshold: int = 1000
    initial_dim_threshold: int = 500
    exploration_factor: float = 0.1
    min_samples_for_adaptation: int = 20
    #: probe a served batch's recall against the f32 exact oracle every
    #: N-th batch_search call (<=32 queries/probe). The probe is what
    #: lets the bandit learn that a capacity tier (exact_fast /
    #: lsh / graph) is losing recall on THIS workload — latency alone
    #: would happily pick a fast wrong tier (clustered data breaks
    #: bf16+approx ranking; measured recall 0.70 at 4k clustered).
    #: 0 disables probing.
    recall_probe_interval: int = 8
    #: quality floor for arbitration: an arm whose MEASURED recall sits
    #: below this loses _select_by_performance to any arm meeting it,
    #: regardless of latency (the reference's flagship table serves
    #: 0.96-0.98 recall — a 0.34-recall graph tier "winning" on its
    #: 0.15 ms latency is not parity). Probe misses also bump the graph
    #: tier's ef multiplicatively (and decay it on comfortable passes),
    #: extending adaptive.go:316-343's latency-threshold self-tuning to
    #: the quality axis. 0 disables both. Default matches the
    #: reference's own flagship quality (0.96-1.00 across its table —
    #: a 0.95 target let a 0.94-recall graph arm win the 1k row the
    #: reference serves at 1.00).
    recall_target: float = 0.98
    #: ceiling for the self-tuned graph ef.
    max_ef: int = 1024
    #: CAPACITY arms for the bandit (extending adaptive.go:196-241's strategy set to this engine's capacity
    #: axes): each entry is a reduced-precision HBM rung ("int8",
    #: "bf16", "fp16") served as its own strategy `exact_<rung>` from a
    #: device table sharing the exact tier's host store. The recall
    #: probes + quality floor guard them — clustered data that breaks
    #: int8 ranking demotes that arm within one probe interval.
    capacity_arms: tuple = ()

    def validate(self) -> None:
        if self.window_size <= 0:
            raise ValueError("window_size must be > 0")
        if not (0 <= self.exploration_factor <= 1):
            raise ValueError("exploration_factor must be in [0,1]")
        if self.recall_probe_interval < 0:
            raise ValueError("recall_probe_interval must be >= 0")
        if not (0 <= self.recall_target <= 1):
            raise ValueError("recall_target must be in [0,1]")
        if self.max_ef < 1:
            raise ValueError("max_ef must be >= 1")
        for arm in self.capacity_arms:
            canonical_dtype(arm, ("int8", "bf16", "fp16"),
                            "capacity_arms entry")


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Disk-backed store configuration (Parquet/Arrow persistence + WAL).

    Mirrors reference ``ParquetStorageConfig`` / ``IncrementalConfig``
    defaults (parquet/storage.go:18-48, parquet/incremental.go:37-51).
    """

    directory: str = ""
    compression: str = "snappy"
    max_pending_writes: int = 1000
    wal_max_changes: int = 1000
    wal_max_age_seconds: float = 3600.0
    wal_max_log_files: int = 5
    #: age-based background WAL flush (the reference's 30s flush
    #: goroutine, parquet/vector_ops.go:80-95). 0 disables the thread.
    wal_flush_interval_seconds: float = 30.0
    #: flush the WAL to disk after EVERY mutation (full durability at
    #: the cost of one log write per change). Default matches the
    #: reference: buffered, volatile until flush.
    wal_sync_writes: bool = False
    #: keep vectors DISK-resident (memory-mapped row file) instead of
    #: in RAM — the reference parquet VectorStore's capability for
    #: N >> RAM (parquet/vector_ops.go:18-63).
    vectors_on_disk: bool = False
    #: serve graph hops from an int8-only HBM store and rerank the pool
    #: head against the disk store on host (Graph.hbm_mode="quantized")
    #: — ~5x more vectors per chip; pairs with vectors_on_disk.
    hbm_quantized: bool = False
    #: full Graph.hbm_mode passthrough: "full" (default), "quantized"
    #: (same as hbm_quantized=True), or "float16" — fp16 traversal
    #: store + exact f32 host rerank, the capacity tier for tightly
    #: clustered data that int8 misranks (half the HBM/gather bytes of
    #: f32, recall parity).  Takes precedence over ``hbm_quantized``
    #: when set to a non-default value.
    hbm_mode: str = "full"
    format: str = "parquet"  # "parquet" | "arrow" | "npz"

    def validate(self) -> None:
        if not self.directory:
            raise ValueError("directory must be set")
        if self.format not in ("parquet", "arrow", "npz"):
            raise ValueError(f"bad format {self.format}")
        if self.wal_flush_interval_seconds < 0:
            raise ValueError("wal_flush_interval_seconds must be >= 0")
        object.__setattr__(self, "hbm_mode", canonical_dtype(
            self.hbm_mode, ("full", "quantized", "float16"), "hbm_mode"))


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Multi-device execution configuration (device mesh).

    No reference analogue — the reference is single-process
    (SURVEY.md §2.7); this is the scale-out axis across devices.
    """

    #: mesh axis name used for sharding vectors / queries.
    data_axis: str = "data"
    #: how to shard: "queries" (replicated index, sharded query batch),
    #: "rows" (sharded vector rows, all-gathered top-k merge).
    strategy: str = "rows"

    def validate(self) -> None:
        if self.strategy not in ("queries", "rows"):
            raise ValueError(f"bad strategy {self.strategy}")
