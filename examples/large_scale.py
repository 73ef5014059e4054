"""Large-scale serving on a GPU: the strategy crossovers.

On an accelerator, brute-force exact scan (the fused scan + top-k
kernel, ops/pallas_exact) stays the fast path far beyond where CPU
libraries switch to graphs. The hybrid index therefore keeps datasets
in the exact tier longer, moves to IVF partition scans for very large
clustered corpora, and uses the HNSW graph (block layout + pivot entry,
auto fp16 blocks on tight clusters) for incremental/delete-heavy
workloads and multi-device partitioned serving. Speeds on the H100 are
not measured here; ``chip_smoke.py`` prints the exact tier's.

Run: python examples/large_scale.py          (needs a GPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import time

import numpy as np


def main():
    from hnsw_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from hnsw_tpu import ExactIndex, HybridConfig, HybridIndex, IVFIndex

    rng = np.random.default_rng(0)
    n, d = 200_000, 128
    print(f"dataset: {n} x {d} (clustered)")
    centers = rng.standard_normal((200, d)).astype(np.float32) * 4
    asg = rng.integers(0, 200, n)
    data = (centers[asg]
            + 0.5 * rng.standard_normal((n, d)).astype(np.float32))
    queries = (centers[rng.integers(0, 200, 1024)]
               + 0.5 * rng.standard_normal((1024, d)).astype(np.float32))

    # exact tier (the fused kernel serves this size on a GPU)
    ex = ExactIndex(metric="cosine")
    ex.batch_add(np.arange(n), data)
    ex.batch_search(queries, 10)  # warm
    t0 = time.perf_counter()
    gt_keys, _ = ex.batch_search(queries, 10)
    dt = time.perf_counter() - t0
    print(f"exact:  {1024 / dt:.0f} qps (recall 1.0 by definition)")

    # IVF partition scans (clustered data is its home turf)
    ivf = IVFIndex(num_partitions=256, nprobe=16, kmeans_iters=6)
    t0 = time.perf_counter()
    ivf.build(list(range(n)), data)
    print(f"ivf build: {time.perf_counter() - t0:.0f}s")
    ivf.batch_search(queries, 10)  # warm
    t0 = time.perf_counter()
    keys, _ = ivf.batch_search(queries, 10)
    dt = time.perf_counter() - t0
    hits = sum(len({x for x in keys[i] if x is not None} &
                   {int(x) for x in gt_keys[i]}) for i in range(1024))
    print(f"ivf:    {1024 / dt:.0f} qps recall@10={hits / 10240:.3f}")

    # capacity mode: reduced-precision HBM table + f32 host rerank.
    # "auto" walks the fidelity ladder (int8 -> bf16 -> fp16 -> f32)
    # against THIS data, so tight clusters never silently degrade;
    # this demo just shows the knob.
    cap = ExactIndex(metric="cosine", hbm_dtype="auto")
    cap.batch_add(np.arange(n), data)
    cap.batch_search(queries, 10)  # warm + resolve the rung
    t0 = time.perf_counter()
    keys, _ = cap.batch_search(queries, 10)
    dt = time.perf_counter() - t0
    hits = sum(len({x for x in keys[i] if x is not None} &
                   {int(x) for x in gt_keys[i]}) for i in range(1024))
    print(f"capacity[{cap._resolved_hbm}]: {1024 / dt:.0f} qps "
          f"recall@10={hits / 10240:.3f}")

    # very long device builds are restartable: Graph.build(...,
    # checkpoint_path="ckpt.npz") snapshots every 128 waves and
    # Graph.resume_build("ckpt.npz") picks up after a crash/kill.


if __name__ == "__main__":
    main()
