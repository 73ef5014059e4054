"""Hybrid / LSH / partitioner / adaptive tests.

Recall harness mirrors hybrid/benchmark_test.go:273's pattern: exact
index provides ground truth; each strategy's recall is measured
against it.
"""

import numpy as np
import pytest

from hnsw_tpu.config import AdaptiveConfig, HybridConfig
from hnsw_tpu.index.adapters import MultiIndexAdapter, SearchableIndex
from hnsw_tpu.index.adaptive import AdaptiveHybridIndex, AdaptiveSelector
from hnsw_tpu.index.exact import ExactIndex
from hnsw_tpu.index.hnsw import Graph
from hnsw_tpu.index.hybrid import HybridIndex
from hnsw_tpu.index.lsh import LSHIndex
from hnsw_tpu.index.partitioner import Partitioner
from hnsw_tpu.ops.topk import np_exact_topk
from tests.conftest import make_vectors


# ------------------------------------------------------------------ LSH

def test_lsh_recall_reasonable():
    n, d, k = 400, 32, 10
    v = make_vectors(n, d, seed=60, kind="clustered")
    idx = LSHIndex(num_tables=8, num_bits=6)
    idx.batch_add(list(range(n)), v)
    q = v[:20] + 0.01 * make_vectors(20, d, seed=61)
    _, gt = np_exact_topk(q, v, k, "cosine")
    keys, _ = idx.batch_search(q, k)
    hits = sum(len({x for x in keys[i] if x is not None} &
                   set(map(int, gt[i]))) for i in range(20))
    assert hits / (20 * k) >= 0.3  # LSH is coarse; candidates must help
    # the query vector itself must always be found
    for i in range(20):
        assert keys[i][0] == i


def test_lsh_candidates_and_delete():
    v = make_vectors(100, 16, seed=62)
    idx = LSHIndex()
    idx.batch_add(list(range(100)), v)
    cands = idx.get_candidates(v[5])
    assert 5 in cands
    assert idx.delete(5)
    assert 5 not in idx.get_candidates(v[5])
    assert not idx.delete(5)
    assert len(idx) == 99


def test_lsh_duplicate_key_replace():
    idx = LSHIndex()
    idx.add("a", np.ones(8, np.float32))
    idx.add("a", -np.ones(8, np.float32))
    assert len(idx) == 1
    assert idx.search(-np.ones(8, np.float32), 1)[0][0] == "a"


# ----------------------------------------------------------- partitioner

def test_partitioner_assign_and_rebalance():
    v = make_vectors(200, 16, seed=63, kind="clustered")
    p = Partitioner(4)
    parts = p.batch_assign(list(range(200)), v)
    assert len(parts) == 200
    assert sum(p.partition_sizes()) == 200
    moved = p.rebalance()
    assert sum(p.partition_sizes()) == 200
    assert moved >= 0
    # nearby vectors land in the same partition
    a = p.assign("x", v[0])
    b = p.assign("y", v[0] + 1e-4)
    assert a == b
    assert p.remove("x")
    assert not p.remove("x")
    s = p.stats()
    assert s["total"] == 201


# ---------------------------------------------------------------- hybrid

def test_hybrid_small_uses_exact():
    v = make_vectors(50, 16, seed=64)
    h = HybridIndex(config=HybridConfig(exact_threshold=100))
    h.batch_add(list(range(50)), v)
    res = h.search(v[7], 5)
    assert res[0][0] == 7
    assert h.stats.last_strategy == "exact"
    assert len(h) == 50


def test_hybrid_migrates_past_threshold():
    v = make_vectors(300, 16, seed=65)
    h = HybridIndex(config=HybridConfig(exact_threshold=100))
    h.batch_add(list(range(100)), v[:100])
    assert h.stats.last_strategy == ""
    assert len(h.exact) == 100
    h.batch_add(list(range(100, 300)), v[100:])
    assert len(h.exact) == 0            # migrated
    assert len(h.graph) == 300
    res = h.search(v[42], 5)
    assert res[0][0] == 42
    assert h.stats.last_strategy == "hnsw"
    _, gt = np_exact_topk(v[:10], v, 5, "cosine")
    keys, _ = h.batch_search(v[:10], 5)
    hits = sum(len({x for x in keys[i] if x is not None} &
                   set(map(int, gt[i]))) for i in range(10))
    assert hits / 50 >= 0.8


def test_hybrid_delete_fans_out():
    v = make_vectors(150, 8, seed=66)
    h = HybridIndex(config=HybridConfig(exact_threshold=50))
    h.batch_add(list(range(150)), v)
    assert h.delete(3)
    assert not h.delete(3)
    assert len(h) == 149
    keys, _ = h.batch_search(v[3:4], 5)
    assert 3 not in keys[0]
    assert h.get_partition_stats()["total"] == 149
    assert h.force_rebalance() >= 0


# --------------------------------------------------------------- adaptive

def test_adaptive_selector_thresholds_and_exploration():
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0))
    q = np.ones(16, np.float32)
    # small dataset -> exact
    assert sel.select_strategy(q, 100, 16) == "exact"
    # large dim -> lsh
    assert sel.select_strategy(q, 10_000, 1024) == "lsh"
    # medium -> hnsw (first sightings; cluster kicks in after repeats)
    q2 = np.arange(16).astype(np.float32)
    assert sel.select_strategy(q2, 10_000, 64) == "hnsw"
    for _ in range(4):
        sel.select_strategy(q2, 10_000, 64)
    assert sel.select_strategy(q2, 10_000, 64) == "hybrid"


def test_adaptive_selector_performance_override():
    from hnsw_tpu.telemetry import QueryMetrics
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                          min_samples_for_adaptation=10))
    for i in range(20):
        # comparable recall means MEETING cfg.recall_target (0.98
        # default) — a 0.95-recall arm is below the floor and must NOT
        # win on latency (test_below_target_arm_loses_arbitration)
        sel.record(QueryMetrics(strategy="hnsw", duration_s=0.001,
                                result_count=10, recall=0.99))
        sel.record(QueryMetrics(strategy="exact", duration_s=0.1,
                                result_count=10, recall=1.0))
    # hnsw is 100x faster at comparable recall -> should win
    q = np.ones(8, np.float32)
    assert sel.select_strategy(q, 50, 8) == "hnsw"


def test_adaptive_hybrid_end_to_end():
    v = make_vectors(300, 24, seed=67)
    a = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(exact_threshold=100),
        adaptive_config=AdaptiveConfig(exploration_factor=0.0))
    a.batch_add(list(range(300)), v)
    assert len(a) == 300
    res = a.search(v[11], 5)
    assert res[0][0] == 11
    a.search(v[12], 5)  # first sample per strategy is warm-up, unrecorded
    stats = a.get_stats()
    assert stats["total_queries"] >= 1
    assert a.delete(11)
    res = a.search(v[11], 5)
    assert res[0][0] != 11
    out = a.batch_search(v[:4], 3)
    assert len(out) == 4


def test_multi_index_adapter():
    v = make_vectors(80, 8, seed=68)
    e = ExactIndex()
    l = LSHIndex()
    m = MultiIndexAdapter([e, l])
    m.batch_add(list(range(80)), v)
    assert len(m) == 80
    res = m.search(v[9], 5)
    assert res[0][0] == 9
    assert m.delete(9)
    assert m.search(v[9], 1)[0][0] != 9
    assert isinstance(e, SearchableIndex)
    g = Graph(seed=0)
    assert isinstance(g, SearchableIndex)


def test_hybrid_ivf_large_strategy():
    v = make_vectors(400, 16, seed=130)
    h = HybridIndex(config=HybridConfig(exact_threshold=50,
                                        partition_size=30,
                                        num_partitions=8,
                                        large_strategy="ivf",
                                        ivf_nprobe=8))
    h.batch_add(list(range(400)), v)
    assert h._lsh_tier()          # 400 >= 30*8
    res = h.search(v[9], 5)
    assert res[0][0] == 9
    assert h.stats.last_strategy == "lsh"  # tier name; backed by ivf
    assert h.ivf is not None and len(h.ivf) == 400
    assert h.delete(9)
    assert h.search(v[9], 1)[0][0] != 9


def test_hybrid_readd_does_not_inflate_count():
    v = make_vectors(30, 8, seed=150)
    h = HybridIndex(config=HybridConfig(exact_threshold=100))
    h.batch_add(list(range(30)), v)
    h.batch_add(list(range(10)), v[:10])  # re-add = replace
    assert len(h) == 30
    h.add(5, v[5])
    assert len(h) == 30


def test_hybrid_duplicate_keys_in_batch_counted_once():
    # regression: duplicate keys within one batch_add are one stored
    # vector; stats.total_vectors must not inflate
    from hnsw_tpu.index.hybrid import HybridIndex
    v = make_vectors(4, 8, seed=90)
    h = HybridIndex(exact_threshold=1000)
    h.batch_add(["a", "b", "a"], v[:3])
    assert len(h) == 2
    assert h.stats.total_vectors == 2
    # last write wins
    res = h.search(v[2], 1)
    assert res[0][0] == "a" and res[0][1] < 1e-5
    # re-adding existing keys stays flat
    h.batch_add(["a", "b"], v[2:4])
    assert h.stats.total_vectors == 2


def test_adaptive_batch_search_groups_by_strategy():
    # batched dispatch: one device sweep per strategy group, results
    # identical in shape/quality to per-query search
    from hnsw_tpu.config import AdaptiveConfig
    v = make_vectors(500, 16, seed=91)
    q = make_vectors(64, 16, seed=92)
    a = AdaptiveHybridIndex(
        adaptive_config=AdaptiveConfig(exploration_factor=0.0))
    a.batch_add(list(range(500)), v)
    res = a.batch_search(q, 5)
    assert len(res) == 64
    assert all(len(r) == 5 for r in res)
    # self-NN sanity through the batched path
    res_self = a.batch_search(v[:16], 1)
    assert [r[0][0] for r in res_self] == list(range(16))
    # metrics recorded per query after warm-up batch
    a.batch_search(q, 5)
    stats = a.get_stats()
    assert stats["total_queries"] >= 64


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_target_recall_routing_meets_target(kind):
    """search(..., target_recall=) picks a (tier, param)
    that actually meets the target, measured on held-out queries."""
    from hnsw_tpu.ops.topk import np_exact_topk
    n, d, k, target = 2000, 24, 10, 0.95
    v = make_vectors(n, d, seed=100, kind=kind)
    q = make_vectors(50, d, seed=101, kind=kind)
    h = HybridIndex(HybridConfig(exact_threshold=100,
                                 large_strategy="ivf",
                                 num_partitions=16, partition_size=50))
    h.batch_add(list(range(n)), v)
    keys, _ = h.batch_search(q, k, target_recall=target)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    hits = sum(len({kk for kk in keys[i] if kk is not None}
                   & set(map(int, gt_i[i]))) for i in range(len(q)))
    recall = hits / (len(q) * k)
    assert recall >= target - 0.03, (h.stats.last_strategy, recall)
    # route is cached
    tier = h.stats.last_strategy
    h.batch_search(q, k, target_recall=target)
    assert h.stats.last_strategy == tier


def test_target_recall_one_means_exact_quality():
    n, d, k = 1500, 16, 5
    v = make_vectors(n, d, seed=102)
    h = HybridIndex(HybridConfig(exact_threshold=100))
    h.batch_add(list(range(n)), v)
    res = h.search(v[7], k, target_recall=1.0)
    assert res[0][0] == 7 and res[0][1] < 1e-5


def test_adaptive_exact_fast_capacity_tier():
    """The bandit's exact_fast arm (bf16+approx+f32-rerank on the same
    device table) serves correct top-k when the performance override
    selects it."""
    from hnsw_tpu.telemetry import QueryMetrics
    v = make_vectors(400, 24, seed=103)
    a = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(exact_threshold=100),
        adaptive_config=AdaptiveConfig(exploration_factor=0.0,
                                       min_samples_for_adaptation=10))
    a.batch_add(list(range(400)), v)
    # make exact_fast the clear performance winner
    for _ in range(20):
        a.selector.record(QueryMetrics(strategy="exact_fast",
                                       duration_s=0.0005,
                                       result_count=5, recall=0.99))
        a.selector.record(QueryMetrics(strategy="hnsw", duration_s=0.05,
                                       result_count=5, recall=0.9))
    strategies = a.selector.select_strategies_batch(v[:8], 400, 24)
    assert set(strategies) == {"exact_fast"}
    out = a.batch_search(v[:8], 5)
    assert [r[0][0] for r in out] == list(range(8))


def test_adaptive_recall_probe_feeds_bandit():
    """Every recall_probe_interval-th batch scores the served groups
    against the f32 oracle and records MEASURED recall."""
    v = make_vectors(600, 24, seed=104)
    a = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(exact_threshold=100),
        adaptive_config=AdaptiveConfig(exploration_factor=0.0,
                                       initial_exact_threshold=100,
                                       recall_probe_interval=1))
    a.batch_add(list(range(600)), v)
    # dataset_size > exact_threshold, dim < dim_threshold -> hnsw group
    a.batch_search(v[:16], 5)   # warm-up (unrecorded)
    a.batch_search(v[:16], 5)
    st = a.get_stats()["strategies"].get("hnsw")
    assert st is not None and st["avg_recall"] > 0.5, st


def test_selector_score_penalizes_wrong_fast_tier():
    """At comparable latency, measured recall decides arbitration: a
    fast tier that lost ranking fidelity (clustered-data bf16 collapse)
    must lose to the oracle tier."""
    from hnsw_tpu.telemetry import QueryMetrics
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                          min_samples_for_adaptation=10))
    for _ in range(20):
        sel.record(QueryMetrics(strategy="exact_fast", duration_s=0.0019,
                                result_count=10, recall=0.2))
        sel.record(QueryMetrics(strategy="exact", duration_s=0.002,
                                result_count=10, recall=1.0))
    assert sel._select_by_performance() == "exact"


def test_measured_zero_recall_is_recorded_not_dropped():
    """A tier MEASURED at 0.0 recall must not fall back to the 0.5
    unprobed default (review: recall=0.0 was both the sentinel and a
    legal measurement; MetricsWindow dropped it)."""
    from hnsw_tpu.telemetry import MetricsWindow, QueryMetrics
    w = MetricsWindow(window_size=10)
    w.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                          result_count=10, recall=0.0))
    st = w.by_strategy["lsh"]
    assert st.avg_recall() == 0.0          # measured zero IS zero
    w2 = MetricsWindow(window_size=10)
    w2.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                           result_count=10))          # unprobed
    assert w2.by_strategy["lsh"].avg_recall() is None


def test_forced_reduced_exact_tier_is_not_its_own_oracle():
    """With a FORCED reduced hbm rung the exact arm must not record
    recall=1.0, and the probe oracle must come from the host f32 scan."""
    from hnsw_tpu.config import AdaptiveConfig, HybridConfig
    from hnsw_tpu.index.adaptive import AdaptiveHybridIndex

    rng = np.random.default_rng(3)
    data = rng.standard_normal((300, 32)).astype(np.float32)
    a = AdaptiveHybridIndex(HybridConfig(), AdaptiveConfig())
    a.exact.hbm_dtype = "int8"
    a.exact._resolved_hbm = "int8"
    assert not a._exact_is_oracle()
    a_auto = AdaptiveHybridIndex(HybridConfig(), AdaptiveConfig())
    assert a_auto._exact_is_oracle()       # f32 default IS an oracle
    # host-oracle probe path returns true f32 ground truth
    for i in range(300):
        a.add(i, data[i])
    ok = a._probe_oracle(data[:4], 3)
    assert ok is not None
    for j in range(4):
        assert ok[j][0] == j               # self-NN


def test_below_target_arm_loses_arbitration_despite_latency():
    """An arm measured BELOW recall_target loses to any arm meeting it,
    even at a fraction of the latency (the 0.6 latency weight elected a
    0.15 ms / 0.34-recall graph arm over the exact oracle before)."""
    from hnsw_tpu.telemetry import QueryMetrics
    sel = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                          min_samples_for_adaptation=10,
                                          recall_target=0.95))
    for _ in range(20):
        sel.record(QueryMetrics(strategy="hnsw", duration_s=0.00015,
                                result_count=10, recall=0.34))
        sel.record(QueryMetrics(strategy="exact", duration_s=0.0003,
                                result_count=10, recall=1.0))
    assert sel._select_by_performance() == "exact"
    # with NO arm meeting the target the best weighted score still wins
    sel2 = AdaptiveSelector(AdaptiveConfig(exploration_factor=0.0,
                                           min_samples_for_adaptation=10,
                                           recall_target=0.99))
    for _ in range(20):
        sel2.record(QueryMetrics(strategy="hnsw", duration_s=0.001,
                                 result_count=10, recall=0.5))
        sel2.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                                 result_count=10, recall=0.9))
    assert sel2._select_by_performance() == "lsh"


def test_probe_miss_self_tunes_graph_ef():
    """_note_recall doubles the graph ef on a probe miss (cap max_ef)
    and decays it back on comfortable passes."""
    a = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(ef_search=20),
        adaptive_config=AdaptiveConfig(recall_target=0.95, max_ef=128))
    assert a._graph_ef is None
    a._note_recall("hnsw", 0.6)
    assert a._graph_ef == 40
    a._note_recall("hnsw", 0.6)
    a._note_recall("hybrid", 0.6)
    a._note_recall("hnsw", 0.6)
    assert a._graph_ef == 128              # capped at max_ef
    a._note_recall("hnsw", 0.999)
    assert a._graph_ef == 96               # decays on comfortable pass
    a._note_recall("exact", 0.1)           # non-graph arms: no-op
    assert a._graph_ef == 96
    a._note_recall("hnsw", None)
    assert a._graph_ef == 96


def test_adaptive_serves_target_recall_on_random_data():
    """End-to-end: on random data where the graph tier's default ef=20
    misses badly, the probed bandit + ef self-tuning converge the
    SERVED recall to >= ~recall_target (the reference's flagship table
    serves 0.96-0.98; 0.34 at lower latency is not parity)."""
    from hnsw_tpu.ops.topk import np_exact_topk
    n, d, k = 2000, 64, 10
    v = make_vectors(n, d, seed=105)
    q = make_vectors(64, d, seed=106)
    a = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(exact_threshold=100, ef_search=20),
        adaptive_config=AdaptiveConfig(exploration_factor=0.0,
                                       initial_exact_threshold=100,
                                       min_samples_for_adaptation=6,
                                       recall_probe_interval=1,
                                       recall_target=0.95))
    a.batch_add(list(range(n)), v)
    for _ in range(4):                     # probes feed the bandit
        a.batch_search(q[:32], k)
    out = a.batch_search(q, k)
    _, gt = np_exact_topk(q, v, k, "cosine")
    hits = sum(len({kk for kk, _ in out[i]} & set(gt[i].tolist()))
               for i in range(len(q)))
    assert hits / (len(q) * k) >= 0.9, hits / (len(q) * k)


def test_exploration_serves_champion_backstop():
    """An arm MEASURED below recall_target keeps getting explored (its
    metrics stay fresh) but its results are replaced by the champion's
    before serving — both in batch_search and single-query search."""
    from hnsw_tpu.telemetry import QueryMetrics
    n, d, k = 800, 32, 5
    v = make_vectors(n, d, seed=107)
    a = AdaptiveHybridIndex(
        hybrid_config=HybridConfig(exact_threshold=100),
        adaptive_config=AdaptiveConfig(exploration_factor=0.0,
                                       min_samples_for_adaptation=10,
                                       recall_target=0.95))
    a.batch_add(list(range(n)), v)
    # pin lsh as a measured-below-target arm, exact as the champion
    for _ in range(12):
        a.selector.record(QueryMetrics(strategy="lsh", duration_s=0.001,
                                       result_count=k, recall=0.3))
        a.selector.record(QueryMetrics(strategy="exact",
                                       duration_s=0.002,
                                       result_count=k, recall=1.0))
    assert a._backstop_arm("lsh") == "exact"
    assert a._backstop_arm("exact") is None
    assert a._backstop_arm("hnsw") is None   # unmeasured: no backstop
    a._warmed.update(("lsh", "exact"))
    # force an lsh group through the batch path: results must be the
    # champion's exact top-k
    import unittest.mock as mock
    with mock.patch.object(a.selector, "select_strategies_batch",
                           return_value=["lsh"] * 8):
        out = a.batch_search(v[:8], k)
    assert [r[0][0] for r in out] == list(range(8))
    for r in out:
        assert r[0][1] < 1e-5
    # single-query path: same replacement
    with mock.patch.object(a.selector, "select_strategy",
                           return_value="lsh"):
        res = a.search(v[3], k)
    assert res[0][0] == 3 and res[0][1] < 1e-5


def test_strategy_stats_running_sums_match_window():
    """StrategyStats' O(1) running aggregates stay exact through
    window eviction (deque maxlen) and mixed None/measured recalls."""
    from hnsw_tpu.telemetry import MetricsWindow, QueryMetrics
    rng = np.random.default_rng(9)
    w = MetricsWindow(window_size=16)
    for i in range(100):
        w.record(QueryMetrics(
            strategy="hnsw", duration_s=float(rng.random()),
            result_count=10,
            recall=(float(rng.random()) if i % 3 else None),
            success=bool(i % 7)))
    st = w.by_strategy["hnsw"]
    lats = [m.duration_s for m in st.window]
    recs = [m.recall for m in st.window if m.recall is not None]
    assert abs(st.avg_latency() - sum(lats) / len(lats)) < 1e-12
    assert abs(st.avg_recall() - sum(recs) / len(recs)) < 1e-12
    assert abs(st.success_rate()
               - sum(1 for m in st.window if m.success) / len(st.window)
               ) < 1e-12


def test_batch_delete_facades_single_sweep(monkeypatch, tmp_path):
    """the Hybrid/Adaptive/DiskGraph batch_delete
    facades must route through Graph.batch_delete's ONE vectorized
    in-edge sweep — never a per-key delete() loop (O(B*N*M) where
    O(N*M) exists) — while preserving per-key success flags."""
    import hnsw_tpu.index.hnsw as hnsw_mod
    from hnsw_tpu.io.disk_graph import DiskGraph

    calls = {"batch": 0, "single": 0}
    real_batch = hnsw_mod.Graph.batch_delete
    real_single = hnsw_mod.Graph.delete

    def spy_batch(self, keys, refine=False):
        calls["batch"] += 1
        return real_batch(self, keys, refine=refine)

    def spy_single(self, key):
        calls["single"] += 1
        return real_single(self, key)

    monkeypatch.setattr(hnsw_mod.Graph, "batch_delete", spy_batch)
    monkeypatch.setattr(hnsw_mod.Graph, "delete", spy_single)

    rng = np.random.default_rng(3)
    n, d = 300, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    doomed = list(range(0, n, 3)) + ["never-added"]

    # HybridIndex (exact tier populated + graph tier via migration)
    h = HybridIndex(config=HybridConfig(exact_threshold=50))
    h.batch_add(list(range(n)), data)
    calls.update(batch=0, single=0)
    flags = h.batch_delete(doomed)
    assert calls["batch"] == 1 and calls["single"] == 0, calls
    assert flags[:-1] == [True] * (len(doomed) - 1) and flags[-1] is False
    keys_out, _ = h.batch_search(data[:8], 5)
    gone = set(doomed[:-1])
    assert all(kk not in gone for row in keys_out for kk in row)
    assert h.stats.total_vectors == n - (len(doomed) - 1)

    # AdaptiveHybridIndex
    a = AdaptiveHybridIndex()
    a.batch_add(list(range(n)), data)
    calls.update(batch=0, single=0)
    flags = a.batch_delete(doomed)
    assert calls["batch"] == 1 and calls["single"] == 0, calls
    assert flags[:-1] == [True] * (len(doomed) - 1) and not flags[-1]

    # DiskGraph (WAL records per successful key, one sweep)
    dg = DiskGraph(str(tmp_path / "dg"))
    dg.batch_add(list(range(n)), data)
    calls.update(batch=0, single=0)
    flags = dg.batch_delete(doomed)
    assert calls["batch"] == 1 and calls["single"] == 0, calls
    assert flags[:-1] == [True] * (len(doomed) - 1) and not flags[-1]
    assert len(dg) == n - (len(doomed) - 1)


def test_bandit_capacity_arm_demoted_on_clustered_data():
    """the bandit's capacity arms. Tight clusters
    break int8 ranking (state._int8_block_fit physics) — the oracle
    probe measures it and the quality floor abandons the arm within
    ONE probe interval, serving the champion's results instead. The
    fp16 rung ranks the same data fine and keeps its arm."""
    from hnsw_tpu.config import AdaptiveConfig
    from hnsw_tpu.index.adaptive import AdaptiveHybridIndex

    n, d, k = 3000, 32, 10
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((30, d)).astype(np.float32) * 5
    data = (centers[rng.integers(0, 30, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, 30, 16)]
         + 0.3 * rng.standard_normal((16, d)).astype(np.float32))
    _, gt = np_exact_topk(q, data, k, "cosine")

    idx = AdaptiveHybridIndex(adaptive_config=AdaptiveConfig(
        capacity_arms=("int8", "fp16"), recall_probe_interval=1,
        recall_target=0.95, exploration_factor=1.0))
    assert "exact_int8" in idx.selector.explore
    idx.batch_add(list(range(n)), data)

    # pin exploration to the int8 arm: call 1 warms it, call 2 records
    # its probed recall (one probe interval)
    idx.selector.explore = ("exact_int8",)
    for _ in range(2):
        out = idx.batch_search(q, k)
    st = idx.selector.metrics.stats("exact_int8")
    assert st is not None and st.avg_recall() is not None
    assert st.avg_recall() < 0.95, st.avg_recall()   # measured broken
    # quality floor: the arm is demoted after one probed batch
    assert idx._backstop_arm("exact_int8") == "exact"
    # ... and the SERVED results met the target anyway (champion serve)
    rec = np.mean([len({kk for kk, _ in out[i]} & set(map(int, gt[i])))
                   / k for i in range(16)])
    assert rec >= 0.95, rec

    # fp16 ranks this data (jitter 0.3 >> fp16 spacing): arm survives
    idx.selector.explore = ("exact_fp16",)
    for _ in range(2):
        idx.batch_search(q, k)
    st16 = idx.selector.metrics.stats("exact_fp16")
    assert st16 is not None and st16.avg_recall() is not None
    assert st16.avg_recall() >= 0.95, st16.avg_recall()
    assert idx._backstop_arm("exact_fp16") is None
    idx.close()


def test_bandit_stream_arm_serves_and_is_probed(tmp_path):
    """The streaming (disk) tier joins the bandit via attach_stream:
    writes fan out to it, its arm serves real results, and the oracle
    probe measures it like any arm."""
    from hnsw_tpu.config import AdaptiveConfig
    from hnsw_tpu.index.adaptive import AdaptiveHybridIndex
    from hnsw_tpu.index.streaming import StreamingExactIndex

    n, d, k = 600, 16, 5
    v = make_vectors(n, d, seed=77)
    q = make_vectors(8, d, seed=78)
    idx = AdaptiveHybridIndex(adaptive_config=AdaptiveConfig(
        recall_probe_interval=1, recall_target=0.9,
        exploration_factor=1.0))
    idx.attach_stream(StreamingExactIndex(str(tmp_path / "st"),
                                          metric="cosine"))
    assert "stream" in idx.selector.explore
    idx.batch_add(list(range(n)), v)
    assert len(idx.stream) == n

    idx.selector.explore = ("stream",)
    for _ in range(2):
        out = idx.batch_search(q, k)
    st = idx.selector.metrics.stats("stream")
    assert st is not None and st.count > 0
    # streaming exact is f32-faithful: measured at/near 1.0
    assert st.avg_recall() is not None and st.avg_recall() >= 0.9
    _, gt = np_exact_topk(q, v, k, "cosine")
    rec = np.mean([len({kk for kk, _ in out[i]} & set(map(int, gt[i])))
                   / k for i in range(8)])
    assert rec >= 0.9
    # deletes fan out to the stream tier too
    assert idx.delete(0)
    assert len(idx.stream) == n - 1
    idx.close()


def test_bandit_ivf_arm_elected_on_clustered_data():
    """the bandit's IVF arm. On clustered >=50k data
    the auto-nprobe IVF tier meets the recall floor while a graph arm
    at its configured ef and the LSH buckets measure below it — the
    meets-target-first selection key must elect ivf over both
    regardless of their latency edge."""
    from hnsw_tpu.config import AdaptiveConfig
    from hnsw_tpu.index.adaptive import AdaptiveHybridIndex
    from hnsw_tpu.telemetry import QueryMetrics

    n, d, k = 50_000, 32, 10
    rng = np.random.default_rng(11)
    nc = 500
    centers = rng.standard_normal((nc, d)).astype(np.float32) * 5
    data = (centers[rng.integers(0, nc, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, nc, 32)]
         + 0.3 * rng.standard_normal((32, d)).astype(np.float32))

    idx = AdaptiveHybridIndex(adaptive_config=AdaptiveConfig(
        recall_probe_interval=1, recall_target=0.95,
        exploration_factor=1.0))
    assert "ivf" in idx.selector.explore
    idx.batch_add(list(range(n)), data)
    assert len(idx.ivf) == n            # writes fan out to the arm

    # pin exploration to the ivf arm: call 1 warms it, call 2 records
    # its probed recall (one probe interval)
    idx.selector.explore = ("ivf",)
    for _ in range(2):
        out = idx.batch_search(q, k)
    st = idx.selector.metrics.stats("ivf")
    assert st is not None and st.avg_recall() is not None
    assert st.avg_recall() >= 0.95, st.avg_recall()
    assert idx._backstop_arm("ivf") is None   # meets the floor

    _, gt = np_exact_topk(q, data, k, "cosine")
    rec = np.mean([len({kk for kk, _ in out[i]} & set(map(int, gt[i])))
                   / k for i in range(len(q))])
    assert rec >= 0.95, rec

    # competitors measured below the floor but faster: the quality
    # floor must still elect ivf over both (the exact arm is popped —
    # this assertion is specifically ivf-vs-hnsw/lsh arbitration)
    for arm in ("hnsw", "lsh"):
        for _ in range(5):
            idx.selector.record(QueryMetrics(
                strategy=arm, duration_s=1e-4, result_count=k,
                success=True, recall=0.5))
    idx.selector.metrics.by_strategy.pop("exact", None)
    pick = idx.selector._select_by_performance()
    assert pick == "ivf", pick

    # ...and a non-exploring batch then SERVES through the elected arm
    idx.selector.cfg = AdaptiveConfig(
        recall_probe_interval=1, recall_target=0.95,
        exploration_factor=0.0)
    before = idx.selector.metrics.stats("ivf").count
    out2 = idx.batch_search(q, k)
    assert idx.selector.metrics.stats("ivf").count > before
    rec2 = np.mean([len({kk for kk, _ in out2[i]} & set(map(int, gt[i])))
                    / k for i in range(len(q))])
    assert rec2 >= 0.95, rec2
    assert idx.delete(0)                # deletes fan out to the arm
    assert len(idx.ivf) == n - 1
    idx.close()
