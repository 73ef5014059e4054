"""Benchmark sweep over the BASELINE.json configs.

Emits one JSON line per measurement to stdout (and optionally a file).
Covers:
  1. cosine HNSW build+search, 10k x 128 random f32 (recall@10 vs QPS
     over an ef sweep) — graph / exact / IVF strategies
  2. l2 + dot metrics on normalized 10k x 100 ("GloVe-100 angular"
     proxy: the real datasets are not fetchable in this zero-egress
     environment; synthetic angular data stands in, same shapes)
  3. bulk batched insert + batch delete with neighbor repair
  4. hybrid adaptive dispatch behavior
  5. faceted + negative-example query overhead

Usage:
  python benchmarks/sweep.py            # full sizes (needs a GPU)
  python benchmarks/sweep.py --small    # reduced sizes, on the CPU
  python benchmarks/sweep.py --cpu      # full sizes, on the CPU

Every row carries the platform it ran on; the first line is the device
header (platform, device kind, count, card name and power limit). Only
``--small``/``--cpu`` run without a GPU, because the caller asked.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def emit(rec):
    print(json.dumps(rec), flush=True)


def recall_of(ids, gt, k):
    hits = sum(len({int(x) for x in ids[i][:k] if x is not None and
                    (not hasattr(x, "item") or x >= 0)} &
                   set(map(int, gt[i][:k]))) for i in range(len(gt)))
    return hits / (len(gt) * k)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--big", action="store_true",
                    help="append device-generated 1M/8M exact-tier "
                         "roofline rows (mfu/floor_frac)")
    args = ap.parse_args()

    import jax
    if args.cpu or args.small:
        jax.config.update("jax_platforms", "cpu")
    from hnsw_tpu.utils.compile_cache import enable_compile_cache
    from hnsw_tpu.utils.profiling import device_header
    enable_compile_cache()
    header = device_header(require_gpu=not (args.cpu or args.small))
    emit(header)
    import jax.numpy as jnp

    from hnsw_tpu import (AdaptiveHybridIndex, EqualityFilter, Facet,
                          FacetedGraph, Graph, HybridConfig, IVFIndex)
    from hnsw_tpu.ops.topk import exact_topk, np_exact_topk
    from hnsw_tpu.core.search import search_graph
    from hnsw_tpu.utils.roofline import matmul_floor_dt, roofline_fields

    platform = header["platform"]

    def roofline(**kw):
        """mfu/floor_frac fields; a CPU row has no device peak."""
        if platform != "gpu":
            return {}
        return roofline_fields(device_kind=header["device_kind"], **kw)
    n = 800 if args.small else 10_000
    d, k = (32 if args.small else 128), 10
    n_q = 64 if args.small else 1024
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((n_q, d)).astype(np.float32)
    _, gt = np_exact_topk(queries, data, k, "cosine")

    # ---- config 1: cosine build + search sweep -------------------------
    g = Graph(m=16, metric="cosine", seed=0)
    t0 = time.perf_counter()
    g.build(list(range(n)), data, wave=1024)
    emit({"config": "cosine_10kx128", "metric": "bulk_build_seconds",
          "n": n, "value": round(time.perf_counter() - t0, 1),
          "platform": platform})
    g.fast_math = True
    dev = g.device_graph()
    qd = jnp.asarray(queries)

    for ef, E in ((96, 1), (192, 1), (256, 2), (320, 2), (384, 4)):
        f = lambda: search_graph(dev, qd, k=k, ef=ef, metric="cosine",
                                 max_hops=max(128, 2 * ef // E),
                                 fast_math=True, expand=E)
        r = f(); r[0].block_until_ready()
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            r = f()
        r[0].block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        ids = np.asarray(r[1])
        emit({"config": "cosine_10kx128", "strategy": "hnsw", "ef": ef,
              "qps": round(n_q / dt, 0),
              "recall@10": round(recall_of(ids, gt, k), 4),
              "platform": platform})

    # serving config: neighbor-block layout + pivot-seeded entry
    g.block_layout = True
    g.entry_mode = "pivots"
    for ef in (192, 256, 384):
        g.batch_search(queries, k, ef=ef)  # warm/compile
        t0 = time.perf_counter()
        for _ in range(3):
            d_out, i_out = g.batch_search_slots(queries, k, ef=ef)
        dt = (time.perf_counter() - t0) / 3
        emit({"config": "cosine_10kx128", "strategy": "hnsw_block_piv",
              "ef": ef, "qps": round(n_q / dt, 0),
              "recall@10": round(recall_of(i_out, gt, k), 4),
              "platform": platform})
    g.block_layout = False
    g.entry_mode = "descent"

    # ef-autoscale: calibrate_ef installs the cheapest ef meeting the
    # target, then the default-ef serve rides it (ROADMAP item 4).
    # Calibrate on a REAL workload sample — synthesized member-mix
    # probes under-provision fully-random queries (picked ef=20 for a
    # 0.9 target and served 0.45, batch22 first run).
    for tgt in (0.9, 0.95):
        t0 = time.perf_counter()
        ef_c, rec_c = g.calibrate_ef(tgt, k=k, seed=3,
                                     probe_queries=queries[:64])
        cal_s = time.perf_counter() - t0
        g.batch_search(queries, k)  # warm at the installed ef
        t0 = time.perf_counter()
        for _ in range(3):
            _, i_out = g.batch_search_slots(queries, k)
        dt = (time.perf_counter() - t0) / 3
        emit({"config": "cosine_10kx128", "strategy": "hnsw_autoef",
              "target": tgt, "ef": ef_c, "probe_recall": round(rec_c, 4),
              "calibrate_seconds": round(cal_s, 2),
              "qps": round(n_q / dt, 0),
              "recall@10": round(recall_of(i_out, gt, k), 4),
              "platform": platform})
        g._ef_calib.clear()
    g._ef_default = None

    sq = dev.sq_norms
    for fast in (False, True):
        f = lambda: exact_topk(qd, dev.vectors, sq, dev.alive, k=k,
                               metric="cosine", fast_math=fast)
        r = f(); r[0].block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            r = f()
        r[0].block_until_ready()
        dt = (time.perf_counter() - t0) / 3
        floor = matmul_floor_dt(qd, dev.vectors, fast_math=fast)
        emit({"config": "cosine_10kx128",
              "strategy": "exact_fast" if fast else "exact",
              "qps": round(n_q / dt, 0),
              "recall@10": round(recall_of(np.asarray(r[1]), gt, k), 4),
              **roofline(n_q=n_q, n=n, d=d, dt=dt, floor_dt=floor,
                         precision="bf16" if fast else "fp32"),
              "platform": platform})

    ivf = IVFIndex(num_partitions=32, nprobe=8, kmeans_iters=5)
    ivf.build(list(range(n)), data)
    ivf.batch_search(queries, k)  # warm
    t0 = time.perf_counter()
    keys, _ = ivf.batch_search(queries, k)
    dt = time.perf_counter() - t0
    emit({"config": "cosine_10kx128", "strategy": "ivf_p32_probe8",
          "qps": round(n_q / dt, 0),
          "recall@10": round(recall_of(keys, gt, k), 4),
          "platform": platform})

    # Default construction: nprobe="auto" calibrates the smallest probe
    # count meeting the 0.9 recall floor against a sampled exact oracle
    # (fixed probe8 above is kept as the ablation row — it serves 0.51
    # on random 10k, which is why auto is the default).
    ivf_auto = IVFIndex(num_partitions=32, kmeans_iters=5)
    ivf_auto.build(list(range(n)), data)
    ivf_auto.batch_search(queries, k)  # warm + calibrate
    t0 = time.perf_counter()
    keys, _ = ivf_auto.batch_search(queries, k)
    dt = time.perf_counter() - t0
    emit({"config": "cosine_10kx128", "strategy": "ivf_p32_auto",
          "nprobe": ivf_auto._resolve_nprobe(),
          "qps": round(n_q / dt, 0),
          "recall@10": round(recall_of(keys, gt, k), 4),
          "platform": platform})

    # ---- config 2: l2 + dot on angular 100-d ---------------------------
    d2n = 32 if args.small else 100
    ang = rng.standard_normal((n, d2n)).astype(np.float32)
    ang /= np.linalg.norm(ang, axis=1, keepdims=True)
    q2 = rng.standard_normal((n_q, d2n)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    for metric in ("l2", "dot"):
        _, gt2 = np_exact_topk(q2, ang, k, metric)
        g2 = Graph(m=16, metric=metric, seed=0)
        g2.build(list(range(n)), ang, wave=1024)
        g2.fast_math = True
        for ef in (20, 64, 128):
            keys, _ = g2.batch_search(q2, k, ef=ef)  # warm+compile
            t0 = time.perf_counter()
            d_out, i_out = g2.batch_search_slots(q2, k, ef=ef)
            dt = time.perf_counter() - t0
            emit({"config": f"{metric}_angular_10kx100", "strategy": "hnsw",
                  "ef": ef, "qps": round(n_q / dt, 0),
                  "recall@10": round(recall_of(i_out, gt2, k), 4),
                  "platform": platform})

    # ---- config 3: batch delete with neighbor repair --------------------
    g3 = Graph(m=16, seed=0)
    g3.build(list(range(n)), data, wave=1024)
    dele = list(range(0, n, 4))
    t0 = time.perf_counter()
    g3.batch_delete(dele)
    emit({"config": "batch_delete", "metric": "delete_repair_seconds",
          "n_deleted": len(dele),
          "value": round(time.perf_counter() - t0, 2),
          "platform": platform})
    keys, _ = g3.batch_search(queries[:64], k, ef=96)
    alive_gt_idx = [i for i in range(n) if i % 4 != 0]
    _, gt3 = np_exact_topk(queries[:64], data[alive_gt_idx], k, "cosine")
    gt3_keys = np.asarray(alive_gt_idx)[gt3]
    emit({"config": "batch_delete", "metric": "recall_after_delete",
          "value": round(recall_of(keys, gt3_keys, k), 4),
          "platform": platform})
    # scoped post-delete refinement recovers the degraded recall
    g3b = Graph(m=16, seed=0)
    g3b.build(list(range(n)), data, wave=1024)
    t0 = time.perf_counter()
    g3b.batch_delete(dele, refine=True)
    emit({"config": "batch_delete", "metric": "delete_refine_seconds",
          "n_deleted": len(dele),
          "value": round(time.perf_counter() - t0, 2),
          "platform": platform})
    keys, _ = g3b.batch_search(queries[:64], k, ef=96)
    emit({"config": "batch_delete", "metric": "recall_after_refine",
          "value": round(recall_of(keys, gt3_keys, k), 4),
          "platform": platform})
    # second repair in the same process = the STEADY-STATE cost (the
    # first pays one-time kernel compiles)
    dele2 = list(range(1, n, 4))
    t0 = time.perf_counter()
    g3b.batch_delete(dele2, refine=True)
    emit({"config": "batch_delete", "metric": "delete_refine_seconds_warm",
          "n_deleted": len(dele2),
          "value": round(time.perf_counter() - t0, 2),
          "platform": platform})

    # ---- config 4: adaptive hybrid (batched strategy-grouped dispatch) ----
    a = AdaptiveHybridIndex(hybrid_config=HybridConfig(exact_threshold=500))
    n4 = min(n, 3000)
    a.batch_add(list(range(n4)), data[:n4])
    a.batch_search(queries[:256], k)           # warm every strategy
    t0 = time.perf_counter()
    res = a.batch_search(queries[:256], k)
    dt = time.perf_counter() - t0
    stats = a.get_stats()
    emit({"config": "adaptive_hybrid", "n": n4,
          "avg_ms": round(dt / 256 * 1000, 3),
          "qps": round(256 / dt, 0),
          "strategies": {s: v["count"] for s, v in
                         stats["strategies"].items()
                         if isinstance(v, dict)},
          "platform": platform})

    # ---- config 4a: single-query LATENCY tier (native C++ serving) --------
    # Reference anchors: adaptive hybrid 2.51 ms/q at 10k x 128
    # (hybrid/README.md:650), parquet single search 128 us
    # (parquet/README.md:69). Batches <= Graph.native_serve_max_batch
    # route to the native engine — no jit dispatch, no device-link RTT.
    # ef=20 is the reference's default efSearch (its 128 us parquet
    # single-search anchor runs at that setting)
    for label, ef_l in (("ef20", 20), ("ef64", 64), ("ef96", 96),
                        ("ef192", 192)):
        lat = []
        for i in range(min(200, n_q)):
            t0 = time.perf_counter()
            g.search(queries[i], k, ef=ef_l)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        keys_l = [[kk for kk, _ in g.search(queries[i], k, ef=ef_l)]
                  for i in range(64)]
        emit({"config": "single_query_latency", "tier": "graph_native",
              "ef": ef_l,
              "p50_ms": round(lat[len(lat) // 2] * 1000, 3),
              "p95_ms": round(lat[int(0.95 * len(lat))] * 1000, 3),
              "recall@10": round(recall_of(keys_l, gt[:64], k), 4),
              "platform": platform})
    # adaptive at FULL n — the reference's 2.51 ms anchor is 10k x 128
    a10 = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(exact_threshold=500))
    a10.batch_add(list(range(n)), data)
    for i in range(20):
        a10.search(queries[i], k)      # warm every strategy
    lat = []
    for i in range(min(200, n_q)):
        t0 = time.perf_counter()
        a10.search(queries[i], k)
        lat.append(time.perf_counter() - t0)
    lat.sort()
    emit({"config": "single_query_latency", "tier": "adaptive",
          "n": n, "p50_ms": round(lat[len(lat) // 2] * 1000, 3),
          "p95_ms": round(lat[int(0.95 * len(lat))] * 1000, 3),
          "avg_ms": round(sum(lat) / len(lat) * 1000, 3),
          "platform": platform})

    # ---- config 4c: the reference's flagship adaptive table ---------------
    # Row-for-row replication of hybrid/README.md:649-652 (M2 Pro):
    #   1k x 128 random     0.052 ms avg, recall 1.00
    #   10k x 128 random    2.51 ms avg,  recall 0.98
    #   10k x 512 random    1.97 ms avg,  recall 0.96
    #   10k x 128 clustered 2.01 ms avg,  recall 0.97
    from benchmarks.datasets import synthetic_standin
    ref_rows = [(1000, 128, "random", 0.052), (n, d, "random", 2.51),
                (n, 512, "random", 1.97), (n, d, "clustered", 2.01)]
    if args.small:
        ref_rows = [(800, 32, "random", 0.052), (800, 32, "clustered",
                                                 2.01)]
    for rn, rd, kind, ref_ms in ref_rows:
        if kind == "random" and (rn, rd) == (n, d):
            at, base_v, qv = a10, data, queries
        else:
            base_v, qv = synthetic_standin(rn, rd, 256, seed=11,
                                           kind=kind)
            at = AdaptiveHybridIndex(
                hybrid_config=HybridConfig(exact_threshold=500))
            at.batch_add(list(range(rn)), base_v)
        for i in range(20):
            at.search(qv[i % len(qv)], k)
        lat = []
        for i in range(200):
            t0 = time.perf_counter()
            at.search(qv[i % len(qv)], k)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        keys_a = [[kk for kk, _ in at.search(qv[i], k)]
                  for i in range(64)]
        _, gta = np_exact_topk(qv[:64], base_v, k, "cosine")
        emit({"config": "adaptive_reference_table",
              "rows": f"{rn}x{rd}_{kind}",
              "avg_ms": round(sum(lat) / len(lat) * 1000, 3),
              "p95_ms": round(lat[int(0.95 * len(lat))] * 1000, 3),
              "recall@10": round(recall_of(keys_a, gta, k), 4),
              "reference_avg_ms": ref_ms,
              "platform": platform})

    # ---- config 4b: recall-aware routing (target_recall contract) ---------
    from hnsw_tpu import HybridIndex
    for kind in ("random", "clustered"):
        if kind == "random":
            base, qs = data, queries
        else:
            from benchmarks.datasets import synthetic_standin
            base, qs = synthetic_standin(n, d, n_q, seed=3,
                                         kind="clustered")
        h = HybridIndex(HybridConfig(exact_threshold=100,
                                     large_strategy="ivf",
                                     num_partitions=32,
                                     partition_size=max(n // 32, 1)))
        h.batch_add(list(range(n)), base)
        for target in (0.9, 0.95, 0.99):
            # 3 warm batches advance the validation back-off (stride
            # 1 -> 8), so the timed batch shows the amortized steady
            # state; B matches the raw-tier rows (the old B=256 timing
            # understated the validated path ~2x on batch economics)
            for _ in range(3):
                keys, _ = h.batch_search(qs, k, target_recall=target)
            t0 = time.perf_counter()
            keys, _ = h.batch_search(qs, k, target_recall=target)
            dt = time.perf_counter() - t0
            _, gtt = np_exact_topk(qs, base, k, "cosine")
            emit({"config": f"target_recall_{kind}", "n": n,
                  "target": target, "route": h.stats.last_strategy,
                  "qps": round(len(qs) / dt, 0),
                  "recall@10": round(recall_of(keys, gtt, k), 4),
                  "platform": platform})

    # ---- config 5: faceted + negative overhead ------------------------------
    fg = FacetedGraph(g)
    for i in range(0, n, 1):
        fg.store.add(i, [Facet("bucket", i % 5)])
    flt = [EqualityFilter("bucket", 3)]
    fg.batch_search(queries[:64], k, flt)        # warm/compile
    t0 = time.perf_counter()
    fg.batch_search(queries[:64], k, flt)
    emit({"config": "faceted", "metric": "filtered_batch64_seconds",
          "value": round(time.perf_counter() - t0, 3),
          "platform": platform})
    fg.batch_search_exact(queries[:64], k, flt)  # warm/compile
    t0 = time.perf_counter()
    fg.batch_search_exact(queries[:64], k, flt)
    emit({"config": "faceted", "metric": "exact_filtered_batch64_seconds",
          "value": round(time.perf_counter() - t0, 3),
          "platform": platform})
    negs = [data[i:i + 1] for i in range(64)]
    g.batch_search_with_negatives(queries[:64], negs, k, 0.5)  # warm
    t0 = time.perf_counter()
    g.batch_search_with_negatives(queries[:64], negs, k, 0.5)
    emit({"config": "negative", "metric": "negative_batch64_seconds",
          "value": round(time.perf_counter() - t0, 3),
          "platform": platform})

    # ---- config 6: disk-tier op timings (ParquetGraph/ArrowGraph
    # baseline rows: add 5.24 ms, search 128 us, delete 2.37 ms,
    # arrow save 11.4 ms / load 2.0 ms, appender 410 us/rec) ----------
    import shutil
    import tempfile

    from hnsw_tpu.config import StoreConfig
    from hnsw_tpu.io.appender import ArrowAppender
    from hnsw_tpu.io.disk_graph import DiskGraph
    nd = min(n, 2000)
    for fmt in ("parquet", "arrow"):
        td = tempfile.mkdtemp(prefix=f"sweep_{fmt}_")
        try:
            dg = DiskGraph(td, store_config=StoreConfig(
                directory=td, format=fmt,
                wal_flush_interval_seconds=0))
            t0 = time.perf_counter()
            dg.batch_add(list(range(nd)), data[:nd])
            add_s = time.perf_counter() - t0
            qn_disk = len(queries[:256])
            dg.batch_search(queries[:qn_disk], k)  # warm SAME batch size
            t0 = time.perf_counter()
            dg.batch_search(queries[:qn_disk], k)
            search_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dg.batch_delete(list(range(64)))
            del_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dg.save()
            save_s = time.perf_counter() - t0
            dg.close()
            t0 = time.perf_counter()
            dg2 = DiskGraph(td, store_config=StoreConfig(
                directory=td, format=fmt,
                wal_flush_interval_seconds=0))
            load_s = time.perf_counter() - t0
            r = dg2.search(data[nd - 1], 1)
            assert r and r[0][0] == nd - 1
            dg2.close()
            emit({"config": f"disk_{fmt}", "n": nd,
                  "add_us_per_vec": round(add_s / nd * 1e6, 1),
                  "search_us_per_q": round(search_s / qn_disk * 1e6, 1),
                  "delete_us_per_key": round(del_s / 64 * 1e6, 1),
                  "save_ms": round(save_s * 1e3, 1),
                  "load_ms": round(load_s * 1e3, 1),
                  "platform": platform})
        finally:
            shutil.rmtree(td, ignore_errors=True)

    # appender streaming ingest (ArrowAppender baseline 410 us/record)
    try:
        import pyarrow as pa
        g6 = Graph(seed=0)
        app = ArrowAppender(g6)
        batch = pa.record_batch(
            {"key": pa.array(list(range(nd)), pa.int64()),
             "vector": pa.array([data[i].tolist() for i in range(nd)],
                                pa.list_(pa.float32()))})
        t0 = time.perf_counter()
        app.append_record(batch)
        emit({"config": "appender", "n": nd,
              "ingest_us_per_rec": round(
                  (time.perf_counter() - t0) / nd * 1e6, 1),
              "platform": platform})
    except ImportError:
        pass

    # ---- config 7: 10k x 512-d (baseline: adaptive hybrid 1.97 ms/q
    # @ recall .96) + distance-abstraction overhead (Surface rows) ----
    if not args.small:
        d512 = 512
        data512 = rng.standard_normal((n, d512)).astype(np.float32)
        q512 = rng.standard_normal((256, d512)).astype(np.float32)
        _, gt512 = np_exact_topk(q512, data512, k, "cosine")
        v512 = jnp.asarray(data512)
        sq512 = jnp.sum(v512 * v512, axis=1)
        alive512 = jnp.ones((n,), bool)
        q512d = jnp.asarray(q512)
        f = lambda: exact_topk(q512d, v512, sq512, alive512,
                               k=k, metric="cosine")
        r = f(); r[0].block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            r = f()
        r[0].block_until_ready()
        dt = (time.perf_counter() - t0) / 3
        emit({"config": "cosine_10kx512", "strategy": "exact",
              "qps": round(256 / dt, 0),
              "recall@10": round(recall_of(np.asarray(r[1]), gt512, k), 4),
              **roofline(n_q=256, n=n, d=d512, dt=dt,
                         floor_dt=matmul_floor_dt(
                             q512d, v512, fast_math=False),
                         precision="fp32"),
              "platform": platform})

    # ---- config 8 (--big): large-N exact-tier roofline ladder ------------
    # mfu/floor_frac at 1M/8M: exact-tier regressions show as ratios
    # against this run's OWN matmul floor. Data generated ON DEVICE.
    if args.big and not args.small:
        for nn in (1 << 20, 8 << 20):
            kv, kq = jax.random.split(jax.random.PRNGKey(7))
            vb = jax.random.normal(kv, (nn, d), jnp.float32)
            sqb = jnp.sum(vb * vb, axis=1)
            alb = jnp.ones((nn,), bool)
            qbig = jax.random.normal(kq, (8192, d), jnp.float32)
            gt_big = np.asarray(exact_topk(qbig, vb, sqb, alb, k=k,
                                           metric="cosine")[1])
            for fast in ((False, True) if nn <= 1 << 20 else (True,)):
                fexa = lambda: exact_topk(qbig, vb, sqb, alb, k=k,
                                          metric="cosine", fast_math=fast)
                r = fexa(); jax.block_until_ready(r)
                t0 = time.perf_counter()
                for _ in range(3):
                    r = fexa()
                jax.block_until_ready(r)
                dt = (time.perf_counter() - t0) / 3
                emit({"config": f"exact_roofline_{nn >> 20}m",
                      "strategy": "exact_fast" if fast else "exact",
                      "qps": round(8192 / dt, 0),
                      "recall@10": round(
                          recall_of(np.asarray(r[1]), gt_big, k), 4),
                      **roofline(
                          n_q=8192, n=nn, d=d, dt=dt,
                          floor_dt=matmul_floor_dt(qbig, vb,
                                                   fast_math=fast),
                          precision="bf16" if fast else "fp32"),
                      "platform": platform})
            del vb, sqb, alb, qbig

    from hnsw_tpu.utils.surface import BasicSurface, VectorDistance
    vd = VectorDistance(BasicSurface("cosine"))
    a_host, b_host = data[:1024], data[1024:2048] if n >= 2048 else data[:1024]
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        vd.batch(a_host, b_host)
    # batch returns the full [A, B] matrix: A*B pairs per call
    pairs = len(a_host) * len(b_host)
    per_call = (time.perf_counter() - t0) / (reps * pairs) * 1e9
    emit({"config": "surface_overhead",
          "batched_ns_per_pair": round(per_call, 2),
          "platform": platform})


if __name__ == "__main__":
    main()
