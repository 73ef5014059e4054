"""Quickstart: build, search, mutate, persist.

Run: python examples/quickstart.py
(Equivalent of the reference's example/main.go basic walkthrough.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import numpy as np

from hnsw_tpu import Graph, SavedGraph


def main():
    rng = np.random.default_rng(0)
    docs = rng.standard_normal((5000, 128)).astype(np.float32)

    g = Graph(m=16, ef_search=20, metric="cosine")
    g.build([f"doc-{i}" for i in range(len(docs))], docs)
    print(f"indexed {len(g)} vectors in {g.num_layers} layers")

    # batched search — the native shape of this engine
    queries = rng.standard_normal((256, 128)).astype(np.float32)
    keys, dists = g.batch_search(queries, k=5, ef=64)
    print("first query neighbors:", list(zip(keys[0], dists[0].round(3))))

    # single-query convenience + self-lookup sanity
    print("nearest to doc-42:", g.search(docs[42], 3))

    # mutation
    g.add("fresh", docs[0] * 0.99)
    g.delete("doc-17")
    print("after mutation:", len(g))

    # negative-example search: demote results similar to a negative
    res = g.search_with_negative(queries[0], docs[7], k=5, neg_weight=0.7)
    print("negative-weighted:", res[:3])

    # self-tuning ef: state a recall target instead of guessing ef.
    # Pass a sample of YOUR workload — synthesized probes under-provision
    # adversarial query distributions.
    ef, measured = g.calibrate_ef(0.9, k=5, probe_queries=queries[:64])
    print(f"calibrated ef={ef} (probe recall {measured:.3f}); "
          "default searches now use it")

    # latency tier: batches <= native_serve_max_batch answer from the
    # first-party C++ engine on host arrays — sub-ms p50, no device RTT
    print("single query (native tier):", g.search(queries[0], 3)[:1])

    # persistence with atomic checkpoints
    sg = SavedGraph(g, "/tmp/quickstart_graph.npz")
    sg.save()
    sg2 = SavedGraph.load("/tmp/quickstart_graph.npz")
    print("reloaded:", len(sg2.graph))


if __name__ == "__main__":
    main()
