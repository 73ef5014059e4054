"""On-card smoke test: hnsw_tpu's exact and graph tiers on one GPU.

    python chip_smoke.py                  # one card, full size
    python chip_smoke.py --four-cards     # the mesh paths on four cards
    JAX_PLATFORMS=cpu python chip_smoke.py --tiny   # CPU rehearsal

Drives the main path through the public entry points (``ExactIndex``,
``Graph``, ``parallel.sharded``) at 1,048,576 x 128 rows (SIFT1M's shape,
``BASELINE.json``), with data made from ``--seed`` by
``benchmarks.datasets.synthetic_standin``. Every phase is compared with
the numpy oracle ``ops.topk.np_exact_topk`` on sampled queries. Each
phase prints one JSON line; the last line of a passing run is exactly
``{"ok": true, "device": {...}}``. No phase catches its own failure: a
failed comparison raises, and the script exits non-zero without that
line. Without a GPU (and without ``--tiny``) it exits non-zero.

``--tiny`` runs the same phases at small sizes on the CPU, with the
fused kernel in Pallas interpret mode. It never reports a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

K = 10
N_ORACLE = 256          # sampled queries compared with the oracle
REPS = 5                # timed repetitions per measurement (median kept)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def result_line(platform: str, kind: str, count: int) -> dict:
    """The final line of a passing run."""
    return {"ok": True,
            "device": {"platform": platform, "kind": kind, "count": count}}


def recall(got_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    k = gt_ids.shape[1]
    hits = sum(len(set(map(int, got_ids[r][:k])) & set(map(int, gt_ids[r])))
               for r in range(len(gt_ids)))
    return hits / gt_ids.size


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn, reps: int = REPS):
    """(first-call seconds, median warm seconds, last result)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return first, sorted(times)[len(times) // 2], out


def block(x):
    import jax
    return jax.block_until_ready(x)


def peak_bytes(dev) -> int | None:
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


class CompileClock:
    """Sums XLA backend compile seconds (JAX's own monitoring event)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax
        self.seconds = 0.0

        def listen(event, duration, **_):
            if event == self.EVENT:
                self.seconds += duration
        jax.monitoring.register_event_duration_secs_listener(listen)


def oracle(queries, base, metric="l2", chunk=65536):
    """Exact top-K in f32 numpy, scanned in row chunks."""
    from hnsw_tpu.ops.topk import np_exact_topk
    best_d = best_i = None
    for c0 in range(0, len(base), chunk):
        d, i = np_exact_topk(queries, base[c0:c0 + chunk], K, metric)
        i = i + c0
        if best_d is None:
            best_d, best_i = d, i
            continue
        dd = np.concatenate([best_d, d], axis=1)
        ii = np.concatenate([best_i, i], axis=1)
        order = np.argsort(dd, axis=1, kind="stable")[:, :K]
        best_d = np.take_along_axis(dd, order, axis=1)
        best_i = np.take_along_axis(ii, order, axis=1)
    return best_d, best_i


def check_exact(name, ids, dists, gt_i, gt_d, floor):
    rec = recall(ids, gt_i)
    check(rec >= floor, f"{name}: recall@10 {rec} < {floor}")
    # compare distances where the ids agree (ties may swap positions)
    worst = 0.0
    for r in range(len(gt_i)):
        gmap = dict(zip(map(int, gt_i[r]), map(float, gt_d[r])))
        for j, key in enumerate(map(int, ids[r][:K])):
            if key in gmap:
                np.testing.assert_allclose(dists[r][j], gmap[key],
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=name)
                worst = max(worst, abs(float(dists[r][j]) - gmap[key]))
    return rec, worst


def phase_exact(args, base, queries, sample, gt_d, gt_i, dev):
    """Phases 1-3: the exact tier at f32, fast and int8, and the fused
    kernel against XLA's scan."""
    import jax
    import jax.numpy as jnp

    from hnsw_tpu import ExactIndex
    from hnsw_tpu.ops.pallas_exact import exact_topk_fused, fused_applies
    from hnsw_tpu.ops.topk import exact_topk

    n = len(base)
    platform = dev.platform
    idx = ExactIndex(metric="l2")
    t0 = time.perf_counter()
    idx.batch_add(list(range(n)), base)
    add_s = time.perf_counter() - t0
    idx.host_serve_max_batch = 0     # measure the device tier at every B

    def served(i_b, d_b):
        return (np.asarray([[-1 if x is None else x for x in row]
                            for row in i_b]), np.asarray(d_b))

    for fast in (False, True):
        idx.fast_math = fast
        name = "exact_fast" if fast else "exact_f32"
        for b in args.batches:
            qb = queries[:b]
            first, med, (keys, dists) = timed(lambda: idx.batch_search(qb, K))
            ids, dists = served(keys, dists)
            rec, worst = check_exact(name, ids[sample], dists[sample],
                                     gt_i, gt_d, 0.99 if fast else 0.999)
            emit({"phase": name, "rows": n, "batch": b, "k": K,
                  "kernel": ("fused" if fused_applies(platform, n, K, "l2")
                             else "xla"),
                  "precision": "bf16 scan + f32 rerank" if fast else
                  "f32 (fused: TF32x3 screen + HIGHEST rerank; "
                  "xla: HIGHEST)",
                  "first_call_s": first, "median_s": med,
                  "qps": b / med, "recall@10": rec,
                  "max_abs_dist_err": worst, "tol": "rtol 1e-4 atol 1e-4",
                  "add_s": add_s, "peak_bytes_in_use": peak_bytes(dev)})

    # phase 2b: capacity scan (int8 table + host f32 rerank)
    cap = ExactIndex(metric="l2", hbm_dtype="int8")
    cap.batch_add(list(range(n)), base)
    cap.host_serve_max_batch = 0
    for b in args.batches:
        qb = queries[:b]
        first, med, (keys, dists) = timed(lambda: cap.batch_search(qb, K))
        ids, dists = served(keys, dists)
        rec, worst = check_exact("exact_int8", ids[sample], dists[sample],
                                 gt_i, gt_d, 0.99)
        emit({"phase": "exact_int8", "rows": n, "batch": b, "k": K,
              "first_call_s": first, "median_s": med, "qps": b / med,
              "recall@10": rec, "max_abs_dist_err": worst,
              "peak_bytes_in_use": peak_bytes(dev)})
    del cap

    # phase 3: fused kernel vs XLA's exact_topk on the same device arrays
    v, sq, alive, _ = idx._sync()
    interpret = platform != "gpu"
    for fast in (False, True):
        for b in args.batches:
            q = jnp.asarray(queries[:b])
            kw = dict(k=K, metric="l2", fast_math=fast)
            mem = exact_topk_fused.lower(
                q, v, sq, alive, interpret=interpret,
                **kw).compile().memory_analysis()
            row = {"phase": "fused_check", "rows": n, "batch": b, "k": K,
                   "fast_math": fast, "fused_memory_analysis": {
                       a: getattr(mem, a, None) for a in (
                           "temp_size_in_bytes", "argument_size_in_bytes",
                           "output_size_in_bytes")}}
            runs = (("xla", lambda: exact_topk(q, v, sq, alive, **kw)),
                    ("fused", lambda: exact_topk_fused(
                        q, v, sq, alive, interpret=interpret, **kw)))
            for name, fn in runs:
                first, med, (dk, ik) = timed(lambda: block(fn()))
                rec, _ = check_exact(f"fused_check/{name}",
                                     np.asarray(ik)[sample],
                                     np.asarray(dk)[sample], gt_i, gt_d,
                                     0.99 if fast else 0.999)
                row.update({f"{name}_first_s": first,
                            f"{name}_median_s": med,
                            f"{name}_recall@10": rec})
            row["fused_speedup"] = row["xla_median_s"] / row["fused_median_s"]
            emit(row)
    return idx


def phase_graph(args, dev):
    """Phase 4: device wave build, served batch search, native tier."""
    from benchmarks.datasets import synthetic_standin
    from hnsw_tpu import Graph, native

    n = args.graph_rows
    base, queries = synthetic_standin(n, 128, min(args.batches),
                                      seed=args.seed + 1, kind="clustered")
    sample = np.arange(min(N_ORACLE, len(queries)))
    gt_d, gt_i = oracle(queries[sample], base)
    clock = CompileClock()
    g = Graph(m=16, metric="l2", seed=args.seed)
    t0 = time.perf_counter()
    g.build(list(range(n)), base, method="device", wave=args.wave)
    build_s = time.perf_counter() - t0
    emit({"phase": "graph_build", "rows": n, "wave": args.wave,
          "build_s": build_s, "build_compile_s": clock.seconds,
          "rows_per_s": n / build_s, "peak_bytes_in_use": peak_bytes(dev)})

    g.fast_math = True
    g.block_layout = True
    g.entry_mode = "pivots"
    for ef in (128, 256):
        c0 = clock.seconds
        first, med, (keys, _) = timed(
            lambda: g.batch_search(queries, K, ef=ef), reps=3)
        ids = np.asarray([[-1 if x is None else x for x in row]
                          for row in keys])
        rec = recall(ids[sample], gt_i)
        if ef == 256:
            check(rec >= 0.9, f"graph ef=256 recall@10 {rec} < 0.9")
        emit({"phase": "graph_search", "rows": n, "batch": len(queries),
              "ef": ef, "first_call_s": first,
              "compile_s": clock.seconds - c0, "median_s": med,
              "qps": len(queries) / med, "recall@10": rec,
              "peak_bytes_in_use": peak_bytes(dev)})

    lats, hits = [], 0
    for qi in range(32):
        t0 = time.perf_counter()
        res = g.search(queries[qi], K, ef=128)
        lats.append(time.perf_counter() - t0)
        hits += len({key for key, _ in res} & set(map(int, gt_i[qi])))
    emit({"phase": "graph_single_query", "rows": n, "queries": 32,
          "native_loaded": native.available(),
          "p50_ms": sorted(lats)[16] * 1e3, "recall@10": hits / (32 * K)})
    return g


def run_one_card(args, dev):
    from benchmarks.datasets import synthetic_standin

    base, queries = synthetic_standin(args.rows, 128, max(args.batches),
                                      seed=args.seed)
    # sampled from the smaller batch, a prefix of the larger: every
    # measured batch holds every sampled query
    small = min(args.batches)
    rng = np.random.default_rng(args.seed)
    sample = np.sort(rng.choice(small, min(N_ORACLE, small), replace=False))
    t0 = time.perf_counter()
    gt_d, gt_i = oracle(queries[sample], base)
    emit({"phase": "oracle", "rows": args.rows, "queries": len(sample),
          "seconds": time.perf_counter() - t0})
    phase_exact(args, base, queries, sample, gt_d, gt_i, dev)
    del base
    phase_graph(args, dev)


def run_four_cards(args):
    """Mesh paths on four cards: row-sharded exact, query-sharded graph,
    row-sharded graph."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from benchmarks.datasets import synthetic_standin
    from hnsw_tpu import Graph
    from hnsw_tpu.core.search import search_graph
    from hnsw_tpu.parallel.rowsharded import (make_row_shards,
                                              rowsharded_graph_search)
    from hnsw_tpu.parallel.sharded import (default_mesh, sharded_exact_topk,
                                           sharded_graph_search)

    n_dev = 4
    check(len(jax.devices()) >= n_dev, f"need {n_dev} devices")
    mesh = default_mesh(n_dev)
    rows = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def shard_report(name, x):
        per = {str(s.device.id): int(np.prod(s.data.shape))
               for s in x.addressable_shards}
        check(len(per) == n_dev and len(set(per.values())) == 1
              and sum(per.values()) == int(np.prod(x.shape)),
              f"{name} is not split evenly over {n_dev} cards: {per}")
        return {"sharding": str(x.sharding.spec), "elems_per_device": per}

    # row-sharded exact scan over n_dev x rows
    n = n_dev * args.rows
    base, queries = synthetic_standin(n, 128, min(args.batches),
                                      seed=args.seed)
    sample = np.arange(min(N_ORACLE, len(queries)))
    gt_d, gt_i = oracle(queries[sample], base)
    v = jax.device_put(base, rows)
    sq = jax.device_put(np.sum(base * base, axis=1), rows)
    valid = jax.device_put(np.ones(n, bool), rows)
    q = jax.device_put(queries, repl)
    first, med, (dk, ik) = timed(lambda: block(sharded_exact_topk(
        q, v, sq, valid, k=K, metric="l2", mesh=mesh)))
    ik, dk = np.asarray(ik), np.asarray(dk)
    rec, worst = check_exact("sharded_exact", ik[sample], dk[sample], gt_i,
                             gt_d, 0.999)
    emit({"phase": "sharded_exact", "rows": n, "devices": n_dev,
          "batch": len(queries), "first_call_s": first, "median_s": med,
          "qps": len(queries) / med, "recall@10": rec,
          **shard_report("vectors", v),
          "peak_bytes_per_device": [peak_bytes(d)
                                    for d in jax.devices()[:n_dev]]})
    del v, sq, valid, base

    # replicated graph, query-sharded search vs the one-card search
    gn = args.graph_rows
    gbase, gq = synthetic_standin(gn, 128, min(args.batches),
                                  seed=args.seed + 1, kind="clustered")
    ggt_d, ggt_i = oracle(gq[sample], gbase)
    g = Graph(m=16, metric="l2", seed=args.seed)
    t0 = time.perf_counter()
    g.build(list(range(gn)), gbase, method="device", wave=args.wave)
    emit({"phase": "graph_build", "rows": gn,
          "build_s": time.perf_counter() - t0})
    dev_g = g.device_graph()
    qg = jnp.asarray(gq)
    _, one_i = search_graph(dev_g, qg, k=K, ef=256, metric="l2",
                            max_hops=128)
    first, med, (d2, i2) = timed(lambda: block(sharded_graph_search(
        dev_g, qg, k=K, ef=256, metric="l2", mesh=mesh)))
    i2 = np.asarray(i2)
    agree = float(np.mean(i2 == np.asarray(one_i)))
    check(agree >= 0.99, f"sharded graph ids agree {agree} < 0.99")
    emit({"phase": "sharded_graph", "rows": gn, "devices": n_dev,
          "batch": len(gq), "first_call_s": first, "median_s": med,
          "qps": len(gq) / med, "ids_equal_one_card": agree,
          "recall@10": recall(i2[sample], ggt_i)})

    # one graph, layer-0 rows sharded over the cards
    shards = make_row_shards(g, n_dev)
    shards = shards._replace(nbr0=jax.device_put(shards.nbr0, rows),
                             vectors=jax.device_put(shards.vectors, rows),
                             sq_norms=jax.device_put(shards.sq_norms, rows))
    first, med, (d3, i3) = timed(lambda: block(rowsharded_graph_search(
        shards, qg, k=K, ef=256, metric="l2", mesh=mesh)))
    rec3 = recall(np.asarray(i3)[sample], ggt_i)
    check(rec3 >= 0.9, f"row-sharded graph recall@10 {rec3} < 0.9")
    emit({"phase": "rowsharded_graph", "rows": gn, "devices": n_dev,
          "batch": len(gq), "first_call_s": first, "median_s": med,
          "qps": len(gq) / med, "recall@10": rec3,
          **shard_report("vectors", shards.vectors),
          "peak_bytes_per_device": [peak_bytes(d)
                                    for d in jax.devices()[:n_dev]]})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="small sizes on the CPU, kernels interpreted")
    p.add_argument("--four-cards", action="store_true",
                   help="run only the mesh paths, on four cards")
    p.add_argument("--rows", type=int, default=None,
                   help="exact-tier rows (per card with --four-cards)")
    p.add_argument("--graph-rows", type=int, default=None)
    args = p.parse_args(argv)
    if args.tiny:
        args.rows = args.rows or 4096
        args.graph_rows = args.graph_rows or 4096
        args.batches = (512, 64)
        args.wave = 1024
    else:
        args.rows = args.rows or 1 << 20
        args.graph_rows = args.graph_rows or 1 << 20
        args.batches = (8192, 1024)
        args.wave = 16384
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hnsw_tpu  # noqa: F401  (fails fast outside a checkout)
    from hnsw_tpu.utils.compile_cache import enable_compile_cache
    from hnsw_tpu.utils.profiling import device_header

    import jax
    if args.tiny:
        jax.config.update("jax_platforms", "cpu")
        if args.four_cards:
            jax.config.update("jax_num_cpu_devices", 4)
    enable_compile_cache()
    try:
        header = device_header(require_gpu=not args.tiny)
    except RuntimeError as e:
        print(f"{e}; use --tiny to rehearse on the CPU", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    emit({**header, "jax": jax.__version__, "seed": args.seed})
    print(header["card"] or "no GPU card", flush=True)
    if args.four_cards:
        run_four_cards(args)
        count = 4
    else:
        run_one_card(args, dev)
        count = len(jax.devices())
    emit(result_line(dev.platform, dev.device_kind, count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
