"""Production serving operations: concurrent search-under-mutation,
capacity-aware adaptive dispatch, and calibration persistence.

Run: JAX_PLATFORMS=cpu python examples/serving_ops.py

Covers the operational surface:
  * the RWMutex concurrency contract (reference graph.go:328): reader
    threads keep serving while a writer mutates;
  * AdaptiveConfig.capacity_arms — reduced-precision HBM rungs as
    bandit arms, demoted by the quality floor when the workload breaks
    them (reference adaptive.go:196-241, extended to capacity axes);
  * calibration persistence — calibrate once, reopen and serve without
    re-paying the oracle scan (reference encode.go:178's convergence
    spirit).
"""

import os
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import numpy as np

from hnsw_tpu import Graph
from hnsw_tpu.config import AdaptiveConfig
from hnsw_tpu.index.adaptive import AdaptiveHybridIndex
from hnsw_tpu.io.codec import load_graph, save_graph

rng = np.random.default_rng(0)
n, d, k = 2000, 32, 5
data = rng.standard_normal((n + 500, d)).astype(np.float32)

# --- 1. concurrent search while another thread mutates -----------------
g = Graph(metric="cosine", seed=0)
g.batch_add(list(range(n)), data[:n])

served = []
stop = threading.Event()


def reader():
    while not stop.is_set():
        res = g.search(data[rng.integers(0, n)], k)
        served.append(len(res))


threads = [threading.Thread(target=reader) for _ in range(2)]
for t in threads:
    t.start()
g.batch_add(list(range(n, n + 500)), data[n:])     # writer: bulk insert
g.batch_delete(list(range(100)))                   # writer: bulk delete
stop.set()
for t in threads:
    t.join()
print(f"served {len(served)} searches concurrently with bulk mutations; "
      f"index now holds {len(g)} vectors")

# --- 2. capacity arms under the quality floor ---------------------------
# tight clusters break int8 ranking; the bandit's oracle probe measures
# it and the champion serves instead — fp16 survives on the same data.
centers = rng.standard_normal((20, d)).astype(np.float32) * 5
clustered = (centers[rng.integers(0, 20, n)]
             + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
eng = AdaptiveHybridIndex(adaptive_config=AdaptiveConfig(
    capacity_arms=("int8", "fp16"), recall_probe_interval=1,
    recall_target=0.95, exploration_factor=0.2))
eng.batch_add(list(range(n)), clustered)
q = (centers[rng.integers(0, 20, 16)]
     + 0.3 * rng.standard_normal((16, d)).astype(np.float32))
for arm in ("exact_int8", "exact_fp16"):
    eng.selector.explore = (arm,)     # pin exploration for the demo
    for _ in range(2):                # warm + one probed batch
        eng.batch_search(q, k)
stats = eng.get_stats()["strategies"]
for arm in ("exact_int8", "exact_fp16"):
    st = stats.get(arm, {})
    print(f"{arm}: measured recall {st.get('avg_recall')} "
          f"(demoted by quality floor: "
          f"{eng._backstop_arm(arm) is not None})")
eng.close()

# --- 3. calibration persists across reopen ------------------------------
g2 = Graph(metric="cosine", seed=0)
g2.batch_add(list(range(n)), data[:n])
ef, rec = g2.calibrate_ef(0.9, k=k)
print(f"calibrated: ef={ef} at recall {rec:.3f}")
with tempfile.TemporaryDirectory() as tmp:
    p = os.path.join(tmp, "g.npz")
    save_graph(g2, p)
    g3 = load_graph(p)
    ef3, rec3 = g3.calibrate_ef(0.9, k=k)   # cached — no oracle scan
    assert (ef3, rec3) == (ef, rec)
    print(f"reopened: ef={ef3} served from the persisted calibration")
