"""Headline benchmark on one GPU.

Config: BASELINE.json #1 — 10k x 128-d random float32, cosine, k=10.
Reference anchor: the Go library's adaptive hybrid engine serves this at
2.51 ms/query ≈ 398 QPS at recall 0.98 (hybrid/README.md:650).

Reports the exact tier's batch throughput at measured recall (the tier
the hybrid dispatch picks at this scale), with the graph tier and the
host latency tier alongside on stderr. Fails without a GPU.

Prints ONE JSON line:
  {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": x,
   "platform": ..., "device_kind": ..., "device_count": ..., "card": ...}
"""

import json
import sys
import time

import numpy as np

# Reference anchor (hybrid/README.md:650): the Go adaptive hybrid
# serves 10k x 128 cosine at 398.4 QPS ≈ 2.51 ms AVG latency at recall
# 0.98. ONE constant — the latency anchor is derived, so a re-measured
# baseline cannot drift apart.
BASELINE_QPS = 398.4
BASELINE_MS = 1000.0 / BASELINE_QPS


def _bench(fn, reps=9):
    """Median-of-reps timing with a spread diagnostic.

    Each rep is timed individually; the MEDIAN resists one-sided
    outliers and ``spread`` = (max-min)/median flags a noisy run. Two
    warm calls: the first compiles, the second absorbs any post-compile
    first-dispatch cost."""
    fn()
    fn()
    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    med = ts[len(ts) // 2]
    spread = (ts[-1] - ts[0]) / med if med > 0 else 0.0
    return med, spread, out


def _latency_rungs(g, data, n):
    """(name, single-query fn) rungs for the host latency tier: the
    native graph beam at two ef points, and the native fused exact
    scan (int8/fp16 SIMD + f32 rerank — the tier the hybrid engine
    routes to at this scale)."""
    from hnsw_tpu.index.exact import ExactIndex
    ex = ExactIndex(metric="cosine")
    ex.batch_add(list(range(n)), data)
    rungs = [(f"hnsw:{ef}", lambda q, _ef=ef: g.search(q, 10, ef=_ef))
             for ef in (192, 384)]
    rungs.append(("exact_scan", lambda q: ex.search(q, 10)))
    return rungs


def main():
    from hnsw_tpu.utils.compile_cache import enable_compile_cache
    from hnsw_tpu.utils.profiling import device_header
    enable_compile_cache()
    header = device_header(require_gpu=True)
    print(f"# {header}", file=sys.stderr)

    import jax.numpy as jnp

    from hnsw_tpu import Graph
    from hnsw_tpu.ops.topk import exact_topk

    n, d, k = 10_000, 128, 10
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, d)).astype(np.float32)

    # ---- build the graph index (HNSW tier) -----------------------------
    g = Graph(m=16, ef_search=20, metric="cosine", seed=0)
    t0 = time.perf_counter()
    g.build(list(range(n)), data, wave=2048)
    build_s = time.perf_counter() - t0
    print(f"# graph build: {build_s:.1f}s", file=sys.stderr)
    g.fast_math = True
    dev = g.device_graph()

    # ---- ground truth ----------------------------------------------------
    n_q = 8192
    queries = jnp.asarray(rng.standard_normal((n_q, d)).astype(np.float32))
    gt_d, gt_i = exact_topk(queries, dev.vectors, dev.sq_norms, dev.alive,
                            k=k, metric="cosine")
    gt = np.asarray(gt_i)

    # ---- hybrid engine serving tier: exact scan --------------------------
    def serve_exact():
        dd, ii = exact_topk(queries, dev.vectors, dev.sq_norms, dev.alive,
                            k=k, metric="cosine")
        ii.block_until_ready()
        return ii

    dt, exact_spread, ii = _bench(serve_exact)
    exact_qps = n_q / dt
    ii = np.asarray(ii)
    hits = sum(len(set(map(int, ii[q])) & set(map(int, gt[q])))
               for q in range(n_q))
    exact_recall = hits / (n_q * k)
    print(f"# hybrid/exact tier: {exact_qps:.0f} qps "
          f"recall@10={exact_recall:.4f} spread={exact_spread:.2f}",
          file=sys.stderr)

    # fast serving mode: bf16 scan + widened top-k + f32 rerank
    def serve_exact_fast():
        dd, ii = exact_topk(queries, dev.vectors, dev.sq_norms, dev.alive,
                            k=k, metric="cosine", fast_math=True)
        ii.block_until_ready()
        return ii

    dt, fast_spread, ii = _bench(serve_exact_fast)
    fast_qps = n_q / dt
    ii = np.asarray(ii)
    hits = sum(len(set(map(int, ii[q])) & set(map(int, gt[q])))
               for q in range(n_q))
    fast_recall = hits / (n_q * k)
    print(f"# hybrid/exact fast_math: {fast_qps:.0f} qps "
          f"recall@10={fast_recall:.4f} spread={fast_spread:.2f}",
          file=sys.stderr)

    # ---- pure HNSW graph tier --------------------------------------------
    # serving config: neighbor-block layout + pivot-seeded entry, bf16
    # traversal, f32 rerank
    g.block_layout = True
    g.entry_mode = "pivots"
    q1k = np.asarray(queries[:1024])
    hnsw_points = []
    hnsw_spreads = {}
    for ef in (192, 256, 384):
        def serve_hnsw():
            keys, _ = g.batch_search(q1k, k, ef=ef)
            return keys

        dt, spr, keys = _bench(serve_hnsw, reps=7)
        hits = sum(len(set(keys[q]) & set(map(int, gt[q])))
                   for q in range(1024))
        rec = hits / (1024 * k)
        hnsw_points.append((ef, 1024 / dt, rec))
        hnsw_spreads[ef] = spr
        print(f"# hnsw graph ef={ef}: {1024 / dt:.0f} qps "
              f"recall@10={rec:.4f} spread={spr:.2f}", file=sys.stderr)

    # ---- native CPU latency tier (single-query serving) ------------------
    # B <= Graph.native_serve_max_batch routes to the C++ engine
    # (native/hnsw_native.cpp) — no jit dispatch, no device round trip.
    # Reference anchor: the Go adaptive hybrid averages 2.51 ms per
    # query on this exact config (hybrid/README.md:650).
    from hnsw_tpu import native as _native
    lat_fields = {}
    if _native.available():
        nq1 = 256
        g.search(q1k[0], k, ef=192)  # warm: engine construction
        rungs = []
        for name, fn1 in _latency_rungs(g, data, n):
            lats, nhits = [], 0
            fn1(q1k[0])  # warm (sidecar build / first-touch)
            for qi in range(nq1):
                t1 = time.perf_counter()
                res = fn1(q1k[qi])
                lats.append(time.perf_counter() - t1)
                nhits += len({kk for kk, _ in res} & set(map(int, gt[qi])))
            p50 = sorted(lats)[nq1 // 2] * 1e3
            mean = sum(lats) / nq1 * 1e3
            rec1 = nhits / (nq1 * k)
            rungs.append((name, p50, mean, rec1))
            print(f"# native single-query [{name}]: p50 {p50:.3f} ms "
                  f"mean {mean:.3f} ms recall@10={rec1:.4f}",
                  file=sys.stderr)
        # ADAPTIVE hybrid engine end-to-end — the exact counterpart of
        # the reference's flagship row (its 2.51 ms is the adaptive
        # engine's AVG at recall .98, bandit overhead included)
        from hnsw_tpu import AdaptiveHybridIndex, HybridConfig
        eng = AdaptiveHybridIndex(
            hybrid_config=HybridConfig(exact_threshold=500))
        eng.batch_add(list(range(n)), data)
        for i in range(64):   # steady state, like the reference table
            eng.search(q1k[i % 1024], k)
        lats, nhits = [], 0
        for qi in range(nq1):
            t1 = time.perf_counter()
            res = eng.search(q1k[qi], k)
            lats.append(time.perf_counter() - t1)
            nhits += len({kk for kk, _ in res} & set(map(int, gt[qi])))
        a_p50 = sorted(lats)[nq1 // 2] * 1e3
        a_mean = sum(lats) / nq1 * 1e3
        a_rec = nhits / (nq1 * k)
        print(f"# adaptive hybrid engine: p50 {a_p50:.3f} ms mean "
              f"{a_mean:.3f} ms recall@10={a_rec:.4f}", file=sys.stderr)
        rungs.append(("adaptive", a_p50, a_mean, a_rec))
        # headline = fastest rung AT THE REFERENCE'S QUALITY POINT
        # (recall >= 0.98, matching the 2.51 ms row); the
        # ratio is mean-to-mean (the reference number is an average)
        # and is omitted when no rung reaches the band.
        band = [r for r in rungs if r[3] >= 0.98]
        lat_fields = {
            "adaptive_engine_mean_ms": round(a_mean, 3),
            "adaptive_engine_p50_ms": round(a_p50, 3),
            "adaptive_engine_recall": round(a_rec, 4),
        }
        if band:
            name, p50, mean, rec1 = min(band, key=lambda r: r[2])
            lat_fields.update({
                "single_query_p50_ms": round(p50, 3),
                "single_query_mean_ms": round(mean, 3),
                "single_query_recall": round(rec1, 4),
                "single_query_tier": name,
                "latency_vs_baseline": round(BASELINE_MS / mean, 1),
            })

    baseline_qps = BASELINE_QPS  # reference adaptive hybrid, same config
    best95 = max((p for p in hnsw_points if p[2] >= 0.95),
                 key=lambda p: p[1],
                 default=max(hnsw_points, key=lambda p: p[2]))
    best98 = max((p for p in hnsw_points if p[2] >= 0.98),
                 key=lambda p: p[1],
                 default=max(hnsw_points, key=lambda p: p[2]))
    print(json.dumps({
        "metric": "hybrid_engine_qps_10kx128_cosine_recall@10",
        "value": round(exact_qps, 0),
        "unit": "qps",
        "vs_baseline": round(exact_qps / baseline_qps, 1),
        "recall": round(exact_recall, 4),
        "exact_fast_qps": round(fast_qps, 0),
        "exact_fast_recall": round(fast_recall, 4),
        "hnsw_qps_at_recall>=0.95": round(best95[1], 0),
        "hnsw_recall": round(best95[2], 4),
        "hnsw_qps_at_recall>=0.98": round(best98[1], 0),
        "hnsw_recall@0.98_point": round(best98[2], 4),
        "hnsw_vs_baseline_at_0.98": round(best98[1] / baseline_qps, 1),
        "exact_qps_spread": round(exact_spread, 3),
        "exact_fast_qps_spread": round(fast_spread, 3),
        "hnsw_qps_spread": round(max(hnsw_spreads.values()), 3),
        "build_seconds": round(build_s, 1),
        **header,
        **lat_fields,
    }))


if __name__ == "__main__":
    main()
