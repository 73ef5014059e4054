"""Hybrid dispatch, IVF, faceted + metadata search, multi-device.

Run: python examples/hybrid_and_facets.py
(Covers the reference's hybrid/, facets/, meta/ example programs.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import numpy as np

from hnsw_tpu import (AdaptiveHybridIndex, EqualityFilter, Facet,
                      FacetedGraph, Graph, HybridConfig, HybridIndex,
                      IVFIndex, MetadataGraph, RangeFilter)


def main():
    rng = np.random.default_rng(1)
    docs = rng.standard_normal((3000, 64)).astype(np.float32)
    keys = list(range(len(docs)))

    # --- hybrid: exact tier below threshold, HNSW above ----------------
    h = HybridIndex(config=HybridConfig(exact_threshold=500))
    h.batch_add(keys, docs)
    print("hybrid strategy:", h._strategy(), "->", h.search(docs[5], 3)[:1])
    print("partition stats:", h.get_partition_stats())

    # --- adaptive: bandit learns the best strategy per workload ---------
    a = AdaptiveHybridIndex()
    a.batch_add(keys[:1000], docs[:1000])
    for q in docs[:50]:
        a.search(q, 5)
    print("adaptive stats:", {k: v for k, v in a.get_stats().items()
                              if k != "strategies"})

    # --- IVF: partition-scanned ANN (the large-N strategy) ---------------
    ivf = IVFIndex(num_partitions=32, nprobe=8)
    ivf.build(keys, docs)
    print("ivf:", ivf.search(docs[7], 3)[:1], ivf.stats()["sizes_max"])

    # --- facets -----------------------------------------------------------
    fg = FacetedGraph(Graph(seed=0))
    for i in range(500):
        fg.add(i, docs[i], [Facet("color", ["red", "blue"][i % 2]),
                            Facet("price", float(i))])
    print("faceted:", fg.search(docs[10], 3, [
        EqualityFilter("color", "red"), RangeFilter("price", max=100)]))
    print("aggregations:", fg.facet_aggregations(docs[10], 20, ["color"]))

    # --- metadata ----------------------------------------------------------
    mg = MetadataGraph(Graph(seed=0))
    mg.batch_add(list(range(200)), docs[:200],
                 [{"title": f"item {i}"} for i in range(200)])
    print("metadata:", mg.search(docs[3], 2)[0])


if __name__ == "__main__":
    main()
