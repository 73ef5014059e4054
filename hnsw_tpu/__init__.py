"""hnsw_tpu — a vector index & query engine on an accelerator.

A ground-up rebuild of the capabilities of TFMV/hnsw (Go HNSW library)
as a batched, array-based, XLA-compiled engine: the hierarchical graph
lives in HBM as fixed-degree int32 neighbor tables, searches run for
thousands of queries in lockstep, and every distance evaluation is a
matmul.

Public API map (reference parity in parentheses):
  Graph               core HNSW index            (hnsw.Graph)
  ExactIndex          brute-force k-NN           (hybrid.ExactIndex)
  LSHIndex            locality-sensitive hashing (hybrid.LSHIndex)
  HybridIndex         tiered strategy dispatch   (hybrid.HybridIndex)
  AdaptiveHybridIndex bandit strategy selection  (hybrid.AdaptiveHybridIndex)
  Partitioner         centroid routing           (hybrid.Partitioner)
  MultiIndexAdapter   fan-out composition        (hybrid.MultiIndexAdapter)
  FacetedGraph        faceted filtering          (facets.FacetedGraph)
  MetadataGraph       JSON payloads              (meta.MetadataGraph)
  Analyzer            structure metrics          (hnsw.Analyzer)
  DiskGraph           durable parquet/arrow/npz  (parquet.ParquetGraph,
                                                  arrow.ArrowGraph)
  ArrowAppender       streaming ingest           (arrow.ArrowAppender)
  save_graph/load_graph/SavedGraph  checkpoints  (hnsw.Export/Import,
                                                  SavedGraph)
  register_distance   custom metrics             (hnsw.RegisterDistanceFunc)
"""

__version__ = "0.1.0"

from hnsw_tpu.analyzer import Analyzer, QualityMetrics
from hnsw_tpu.config import (AdaptiveConfig, GraphConfig, HybridConfig,
                             ShardingConfig, StoreConfig)
from hnsw_tpu.facets import (BasicFacet, EqualityFilter, Facet, FacetedGraph,
                             FacetFilter, FacetStore, MemoryFacetStore,
                             RangeFilter, StringContainsFilter)
from hnsw_tpu.index.adapters import MultiIndexAdapter, SearchableIndex
from hnsw_tpu.index.adaptive import AdaptiveHybridIndex, AdaptiveSelector
from hnsw_tpu.index.exact import ExactIndex
from hnsw_tpu.index.hnsw import Graph
from hnsw_tpu.index.hybrid import HybridIndex, IndexStats
from hnsw_tpu.index.ivf import IVFIndex
from hnsw_tpu.index.lsh import LSHIndex
from hnsw_tpu.index.partitioner import Partitioner
from hnsw_tpu.io.appender import AppenderConfig, ArrowAppender
from hnsw_tpu.io.codec import (SavedGraph, export_graph,
                               import_graph, load_graph, save_graph)
from hnsw_tpu.io.disk_graph import DiskGraph
from hnsw_tpu.meta import (MemoryMetadataStore, MetadataGraph, MetadataStore)
from hnsw_tpu.ops.distance import register_distance
from hnsw_tpu.telemetry import DistanceStats, MetricsWindow, QueryMetrics
