"""Capabilities tour: disk-resident serving, recall targets,
custom metrics, multi-host slices.

Run on CPU:  JAX_PLATFORMS=cpu python examples/disk_and_scale.py
"""
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

rng = np.random.default_rng(0)
docs = rng.standard_normal((5000, 64)).astype(np.float32)

# --- disk-resident vectors: capacity is the disk, not RAM/HBM ---------
from hnsw_tpu.index.streaming import StreamingExactIndex

with tempfile.TemporaryDirectory() as td:
    idx = StreamingExactIndex(td, metric="cosine", chunk_rows=1024)
    idx.batch_add(list(range(len(docs))), docs)
    print("streaming exact:", idx.search(docs[7], 3))

# --- recall-aware routing ---------------------------------------------
from hnsw_tpu import HybridConfig, HybridIndex

h = HybridIndex(HybridConfig(exact_threshold=100, large_strategy="ivf",
                             num_partitions=32, partition_size=200))
h.batch_add(list(range(len(docs))), docs)
res = h.search(docs[42], 5, target_recall=0.95)
print("target_recall route:", h.stats.last_strategy, "->", res[0])

# --- custom distance end-to-end ---------------------------------------
import jax.numpy as jnp

from hnsw_tpu import Graph, register_distance

register_distance(
    "manhattan",
    lambda a, b: float(np.abs(a - b).sum()),
    lambda q, v: jnp.sum(jnp.abs(q[:, None, :] - v[None, :, :]), -1))
g = Graph(metric="manhattan")
g.batch_add(list(range(1000)), docs[:1000])
print("custom metric:", g.search(docs[3], 2))

# --- multi-host slices with replication --------------------------------
from hnsw_tpu.index.exact import ExactIndex
from hnsw_tpu.parallel.multihost import LocalTransport, MultiHostIndex

mh = MultiHostIndex(LocalTransport([ExactIndex() for _ in range(4)]),
                    replicas=2)
mh.batch_add(list(range(2000)), docs[:2000])
print("multihost:", mh.search(docs[11], 2), mh.stats()["per_slice"])
