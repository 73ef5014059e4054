"""Multi-device serving over a device mesh.

Run on CPU with virtual devices:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/multichip.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from hnsw_tpu import Graph
    from hnsw_tpu.parallel.sharded import (default_mesh, sharded_exact_topk,
                                           sharded_graph_search)

    n_dev = len(jax.devices())
    mesh = default_mesh()
    print(f"mesh: {n_dev} x {jax.devices()[0].platform}")

    rng = np.random.default_rng(0)
    docs = rng.standard_normal((4096, 64)).astype(np.float32)

    # data-parallel serving: replicated graph, sharded query batch
    g = Graph(seed=0)
    g.build(list(range(len(docs))), docs, wave=1024)
    queries = jnp.asarray(rng.standard_normal((64 * n_dev, 64))
                          .astype(np.float32))
    d, i = sharded_graph_search(g.device_graph(), queries, k=5, ef=48,
                                metric="cosine", mesh=mesh)
    print("dp search ids[0]:", np.asarray(i)[0])

    # row-sharded exact: each device scans its shard, global top-k merge
    vecs = jnp.asarray(docs)
    sq = jnp.sum(vecs * vecs, axis=1)
    d2, i2 = sharded_exact_topk(queries[:16], vecs, sq,
                                jnp.ones(len(docs), bool), k=5,
                                metric="l2", mesh=mesh)
    print("row-sharded exact ids[0]:", np.asarray(i2)[0])

    # ONE graph larger than a single chip: layer-0 rows sharded over
    # the mesh, per-hop frontier exchange as owner-masked psum
    # (parallel/rowsharded — the reference's distributed sketch,
    # hnsw-extensions.md:233-271, built on device collectives)
    from hnsw_tpu.parallel.rowsharded import (make_row_shards,
                                              rowsharded_graph_search)
    shards = make_row_shards(g, n_dev)
    d3, i3 = rowsharded_graph_search(shards, queries[:16], k=5, ef=64,
                                     metric="cosine", mesh=mesh)
    print("row-sharded SINGLE graph ids[0]:", np.asarray(i3)[0])


if __name__ == "__main__":
    main()
