"""Persistence tests: table codecs, WAL, disk graph, streaming appender.

Mirrors the reference's persistence integration pattern: real temp
dirs, close -> reopen round trips (parquet/graph_test.go:54), WAL
overlay + compaction triggers (parquet/incremental_test.go:13,134,182),
and the in-memory-vs-disk quality oracle (parquet/graph_test.go:179).
"""

import os

import numpy as np
import pytest

from hnsw_tpu import Graph
from hnsw_tpu.io import table as T
from hnsw_tpu.io.appender import ArrowAppender, AppenderConfig
from hnsw_tpu.io.disk_graph import DiskGraph
from hnsw_tpu.io.wal import IncrementalStore
from tests.conftest import make_vectors

FMTS = ["parquet", "arrow", "npz"]


# -------------------------------------------------------------- table codecs

@pytest.mark.parametrize("fmt", FMTS)
def test_vector_table_round_trip(fmt, tmp_path):
    v = make_vectors(20, 8, seed=70)
    p = str(tmp_path / f"v.{T.ext_for(fmt)}")
    T.write_vectors(p, list(range(20)), v, fmt)
    keys, vecs = T.read_vectors(p, fmt)
    assert keys == list(range(20))
    np.testing.assert_allclose(vecs, v, rtol=1e-6)


@pytest.mark.parametrize("fmt", FMTS)
def test_string_keys_round_trip(fmt, tmp_path):
    v = make_vectors(3, 4, seed=71)
    p = str(tmp_path / f"v.{T.ext_for(fmt)}")
    T.write_vectors(p, ["a", "b", "c"], v, fmt)
    keys, _ = T.read_vectors(p, fmt)
    assert keys == ["a", "b", "c"]


@pytest.mark.parametrize("fmt", FMTS)
def test_edges_round_trip(fmt, tmp_path):
    p = str(tmp_path / f"e.{T.ext_for(fmt)}")
    T.write_edges(p, np.array([0, 0, 1]), [1, 2, 3], [2, 3, 1], fmt)
    lids, keys, nbrs = T.read_edges(p, fmt)
    assert list(lids) == [0, 0, 1]
    assert keys == [1, 2, 3]
    assert nbrs == [2, 3, 1]


# ------------------------------------------------------------------- WAL

def test_wal_overlay_and_get(tmp_path):
    w = IncrementalStore(str(tmp_path), fmt="npz", max_changes=3)
    v = make_vectors(5, 4, seed=72)
    w.record_add("a", v[0])
    w.record_add("b", v[1])
    found, vec = w.get_vector("a")        # pending read
    assert found and np.allclose(vec, v[0])
    w.record_add("c", v[2])               # triggers flush (max 3)
    assert w.num_log_files == 1
    assert not w.pending
    found, vec = w.get_vector("b")        # log-file read
    assert found and np.allclose(vec, v[1])
    w.record_delete("a")
    found, vec = w.get_vector("a")
    assert found and vec is None          # tombstone
    ov = w.overlay()
    assert ov["a"] is None and np.allclose(ov["c"], v[2])


def test_wal_compaction(tmp_path):
    w = IncrementalStore(str(tmp_path), fmt="npz", max_changes=2,
                         max_log_files=1)
    v = make_vectors(6, 4, seed=73)
    base_keys = ["x", "y"]
    base_vecs = v[:2]
    for i in range(4):
        w.record_add(f"k{i}", v[i + 2])
    assert w.num_log_files == 2
    assert w.should_compact()
    w.record_delete("x")
    keys, vecs = w.compact(base_keys, base_vecs)
    assert w.num_log_files == 0
    assert set(keys) == {"y", "k0", "k1", "k2", "k3"}
    got = dict(zip(keys, vecs))
    np.testing.assert_allclose(got["y"], v[1])
    np.testing.assert_allclose(got["k2"], v[4])


# ---------------------------------------------------------------- disk graph

@pytest.mark.parametrize("fmt", FMTS)
def test_disk_graph_close_reopen(fmt, tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(120, 16, seed=74)
    g = DiskGraph(d, fmt=fmt)
    g.batch_add(list(range(120)), v)
    res1 = g.search(v[7], 5)
    g.close()
    # reopen: structure restored from tables
    g2 = DiskGraph(d, fmt=fmt)
    assert len(g2) == 120
    res2 = g2.search(v[7], 5)
    assert res2[0][0] == 7
    assert [k for k, _ in res1] == [k for k, _ in res2]


def test_disk_graph_wal_replay_on_open(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(60, 8, seed=75)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(50)), v[:50])
    g.save()
    # adds + delete recorded in WAL but NOT persisted via save
    for i in range(50, 60):
        g.graph.add(i, v[i])
        g.wal.record_add(i, v[i])
    g.wal.record_delete(3)
    g.wal.flush()
    # simulate crash: reopen from disk; WAL must replay
    g2 = DiskGraph(d, fmt="npz")
    assert len(g2) == 59
    assert g2.search(v[55], 1)[0][0] == 55
    assert g2.graph.lookup(3) is None


def test_disk_graph_incremental_reopen_keeps_logs(tmp_path):
    """Small-delta reopen replays the WAL WITHOUT rewriting the base
    tables (the logs stay the durable delta). A second crash-reopen
    must replay the same delta again — nothing may be lost between
    incremental reopens that never compact."""
    d = str(tmp_path / "dg")
    v = make_vectors(70, 8, seed=77)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(60)), v[:60])
    g.save()
    g.wal.discard_logs()
    for i in range(60, 70):
        g.graph.add(i, v[i])
        g.wal.record_add(i, v[i])
    g.wal.record_delete(2)
    g.wal.flush()
    g._stop_flusher.set()  # crash: no compact/persist
    g2 = DiskGraph(d, fmt="npz")
    assert len(g2) == 69
    assert g2.graph.lookup(2) is None
    assert g2.search(v[65], 1)[0][0] == 65
    # the delta was NOT folded into the base: logs must survive
    assert g2.wal.num_log_files > 0
    g2._stop_flusher.set()  # crash again, still without compaction
    g3 = DiskGraph(d, fmt="npz")
    assert len(g3) == 69
    assert g3.graph.lookup(2) is None
    assert g3.search(v[65], 1)[0][0] == 65
    # explicit compaction folds and clears
    g3.compact()
    assert g3.wal.num_log_files == 0
    g3._stop_flusher.set()
    g4 = DiskGraph(d, fmt="npz")
    assert len(g4) == 69 and g4.search(v[65], 1)[0][0] == 65


def test_disk_graph_quality_parity_with_memory(tmp_path):
    # the reference's oracle: disk-backed results ~= in-memory results
    # (parquet/graph_test.go:179, InDelta 0.1 on avg distance)
    v = make_vectors(300, 16, seed=76)
    q = make_vectors(20, 16, seed=77)
    mem = Graph(seed=0)
    mem.batch_add(list(range(300)), v)
    dg = DiskGraph(str(tmp_path / "dg"), fmt="parquet")
    dg.batch_add(list(range(300)), v)
    _, d_mem = mem.batch_search(q, 10, ef=60)
    _, d_dsk = dg.graph.batch_search(q, 10, ef=60)
    assert abs(float(np.mean(d_mem)) - float(np.mean(d_dsk))) < 0.1


def test_disk_graph_stats_and_compact(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(40, 8, seed=78)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(40)), v)
    g.optimize()
    s = g.stats()
    assert s["count"] == 40
    assert s["vectors_bytes"] > 0
    assert s["wal_log_files"] == 0


def test_disk_graph_wal_value_update_survives_reopen(tmp_path):
    # regression: a flushed UPDATE to an existing key (same key set,
    # new vector values) must not be discarded on reopen — and the WAL
    # logs must never be deleted before the new state is persisted
    d = str(tmp_path / "dg")
    v = make_vectors(30, 8, seed=81)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(30)), v)
    g.save()
    new_vec = -v[5]
    g.graph.add(5, new_vec)
    g.wal.record_add(5, new_vec)
    g.wal.flush()
    # simulate crash (no close/compact); reopen must see the update
    g2 = DiskGraph(d, fmt="npz")
    got = g2.graph.lookup(5)
    np.testing.assert_allclose(got, new_vec)
    # and a second reopen (logs now compacted away) must still see it
    g2.close()
    g3 = DiskGraph(d, fmt="npz")
    np.testing.assert_allclose(g3.graph.lookup(5), new_vec)


@pytest.mark.parametrize("fmt", FMTS)
def test_key_identity_round_trip(fmt, tmp_path):
    # regression: string "1" must stay a string; tuple keys must come
    # back as hashable tuples; ints stay ints
    keys = ["1", 2, ("a", 3), "plain", b"\x00\xff", 2.5]
    v = make_vectors(len(keys), 4, seed=82)
    p = str(tmp_path / f"v.{T.ext_for(fmt)}")
    T.write_vectors(p, keys, v, fmt)
    got, _ = T.read_vectors(p, fmt)
    assert got == keys
    assert [type(k) for k in got] == [type(k) for k in keys]
    # edges too
    pe = str(tmp_path / f"e.{T.ext_for(fmt)}")
    T.write_edges(pe, np.array([0, 0]), ["1", ("a", 3)], [2, "1"], fmt)
    _, ek, en = T.read_edges(pe, fmt)
    assert ek == ["1", ("a", 3)] and en == [2, "1"]


def test_disk_graph_mixed_key_types_reopen(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(20, 8, seed=83)
    keys = [("t", i) if i % 3 == 0 else (str(i) if i % 3 == 1 else i)
            for i in range(20)]
    g = DiskGraph(d, fmt="npz")
    g.batch_add(keys, v)
    g.close()
    g2 = DiskGraph(d, fmt="npz")
    assert len(g2) == 20
    for i, k in enumerate(keys):
        got = g2.graph.lookup(k)
        assert got is not None, f"key {k!r} lost on reopen"
        np.testing.assert_allclose(got, v[i], rtol=1e-6)


def test_checkpoint_is_pickle_free(tmp_path):
    # the checkpoint codec must not execute code on load (no pickle)
    import pickletools

    from hnsw_tpu.io.codec import load_graph, save_graph
    v = make_vectors(25, 8, seed=84)
    g = Graph(seed=0)
    keys = [("k", i) if i % 2 else str(i) for i in range(25)]
    g.batch_add(keys, v)
    p = str(tmp_path / "g.npz")
    save_graph(g, p)
    g2 = load_graph(p)  # must work WITHOUT allow_pickle
    assert sorted(map(repr, g2.keys())) == sorted(map(repr, keys))
    res = g2.search(v[7], 1)
    assert res[0][0] == keys[7]


def test_wal_age_based_background_flush(tmp_path):
    # buffered changes must hit disk on age with NO further mutations
    from hnsw_tpu.config import StoreConfig
    d = str(tmp_path / "dg")
    g = DiskGraph(d, store_config=StoreConfig(
        directory=d, format="npz", wal_flush_interval_seconds=0.2,
        wal_max_changes=1000))
    v = make_vectors(3, 4, seed=85)
    g.add(0, v[0])
    assert g.wal.pending  # buffered, not yet durable
    import time as _t
    deadline = _t.time() + 10
    while g.wal.pending and _t.time() < deadline:
        _t.sleep(0.05)
    assert not g.wal.pending and g.wal.num_log_files == 1
    g.close()


def test_wal_sync_writes_mode(tmp_path):
    w = IncrementalStore(str(tmp_path), fmt="npz", max_changes=1000,
                         sync_writes=True)
    v = make_vectors(2, 4, seed=86)
    w.record_add("a", v[0])
    assert not w.pending and w.num_log_files == 1
    w.record_delete("a")
    assert w.num_log_files == 2


# ----------------------------------------------------------------- appender

def test_appender_stream():
    import pyarrow as pa
    v = make_vectors(25, 8, seed=79)
    g = Graph(seed=0)
    app = ArrowAppender(g, AppenderConfig(batch_size=10))

    def batches():
        for i in range(0, 25, 5):
            yield pa.RecordBatch.from_pydict({
                "key": list(range(i, i + 5)),
                "vector": [v[j].tolist() for j in range(i, i + 5)],
            })

    n = app.stream_records(batches())
    assert n == 25
    assert len(g) == 25
    assert g.search(v[13], 1)[0][0] == 13


def test_appender_async_and_validation():
    import pyarrow as pa
    v = make_vectors(10, 4, seed=80)
    g = Graph(seed=0)
    app = ArrowAppender(g)
    h = app.stream_records_async(iter([pa.RecordBatch.from_pydict({
        "key": list(range(10)),
        "vector": [x.tolist() for x in v],
    })]))
    assert h.result(30) == 10
    assert len(g) == 10
    # schema validation errors
    bad = pa.RecordBatch.from_pydict({"key": [1], "vec": [[1.0]]})
    with pytest.raises(ValueError, match="vector"):
        app.append_record(bad)
    bad2 = pa.RecordBatch.from_pydict({"key": [1.5], "vector": [[1.0]]})
    with pytest.raises(ValueError, match="key field"):
        app.append_record(bad2)


def test_incremental_reopen_recall_parity(tmp_path):
    """The delta reopen path (restore structure + insert only the WAL
    keys) must serve the same quality as a from-scratch build of the
    full key set — the parity criterion, on a REAL
    build (the lifecycle benchmark uses synthetic edges, where delta
    parity is meaningless)."""
    n, extra, d, k = 400, 40, 16, 10
    v = make_vectors(n + extra, d, seed=79)
    q = make_vectors(32, d, seed=80)
    dg = DiskGraph(str(tmp_path / "dg"), fmt="npz")
    dg.batch_add(list(range(n)), v[:n])
    dg.save()
    dg.wal.discard_logs()
    for i in range(n, n + extra):
        dg.graph.add(i, v[i])
        dg.wal.record_add(i, v[i])
    dg.wal.flush()
    dg._stop_flusher.set()  # crash: delta lives only in the WAL
    g2 = DiskGraph(str(tmp_path / "dg"), fmt="npz")
    assert len(g2) == n + extra
    fresh = Graph(seed=0)
    fresh.batch_add(list(range(n + extra)), v)
    from hnsw_tpu.ops.topk import np_exact_topk
    _, gt = np_exact_topk(q, v, k, "cosine")

    def rec(graph):
        keys, _ = graph.batch_search(q, k, ef=80)
        return float(np.mean([len(set(row) & set(gt[i])) / k
                              for i, row in enumerate(keys)]))

    r_inc, r_fresh = rec(g2.graph), rec(fresh)
    assert r_inc >= r_fresh - 0.05, (r_inc, r_fresh)
    g2._stop_flusher.set()


def test_codec_int_key_fast_path_and_mixed_fallback(tmp_path):
    """v3 checkpoints store plain-int key tables as one int64 array
    (8M-key graphs were minutes of per-key JSON); mixed keys keep the
    tagged-JSON codec. Both round-trip identically."""
    import numpy as np
    from hnsw_tpu import Graph
    from hnsw_tpu.io.codec import load_graph, save_graph
    from tests.conftest import make_vectors

    v = make_vectors(60, 8, seed=77)
    g = Graph(m=8, seed=0)
    g.batch_add(list(range(40)), v[:40])
    g.delete(3)                       # populate the free list
    p = str(tmp_path / "ints.npz")
    save_graph(g, p)
    with np.load(p) as z:
        assert "keys_int" in z.files and "keys_json" not in z.files
    g2 = load_graph(p)
    assert sorted(k for k in g2.slots.slot_to_key if k is not None) \
        == sorted(k for k in g.slots.slot_to_key if k is not None)
    assert all(type(k) is int for k in g2.slots.slot_to_key
               if k is not None)
    assert g2.search(v[7], 1)[0][0] == 7
    assert g2.slots.free == g.slots.free

    gm = Graph(m=8, seed=0)
    gm.batch_add([1, "a", (2, "b")] + list(range(10, 30)), v[:23])
    pm = str(tmp_path / "mixed.npz")
    save_graph(gm, pm)
    with np.load(pm) as z:
        assert "keys_json" in z.files
    gm2 = load_graph(pm)
    assert gm2.search(v[1], 1)[0][0] == "a"
    assert set(gm2.slots.slot_to_key) >= {1, "a", (2, "b")}


def test_calibration_persists_through_codec(tmp_path):
    """calibrate_ef results survive a checkpoint —
    a reopened index must serve from the cached rung WITHOUT re-running
    the host oracle scan (minutes at 8M on the 1-core host)."""
    from hnsw_tpu.io.codec import load_graph, save_graph

    n, d, k = 600, 24, 5
    v = make_vectors(n, d, seed=90)
    g = Graph(seed=0)
    g.batch_add(list(range(n)), v)
    ef, rec = g.calibrate_ef(0.9, k=k)
    assert g._ef_calib
    p = str(tmp_path / "calib.npz")
    save_graph(g, p)

    g2 = load_graph(p)
    # the oracle scan must NOT run again: poison it
    def boom(*a, **kw):
        raise AssertionError("recalibration oracle scan ran on reopen")
    g2._host_oracle_slots = boom
    ef2, rec2 = g2.calibrate_ef(0.9, k=k)
    assert (ef2, rec2) == (ef, rec)
    assert g2.ef_search == ef


def test_calibration_persists_through_disk_graph(tmp_path):
    """Same contract through DiskGraph metadata: reopen-then-serve with
    no recalibration scan."""
    from hnsw_tpu.io.disk_graph import DiskGraph

    n, d, k = 500, 16, 5
    v = make_vectors(n, d, seed=91)
    dg = DiskGraph(str(tmp_path / "dg"), fmt="parquet")
    dg.batch_add(list(range(n)), v)
    ef, rec = dg.graph.calibrate_ef(0.9, k=k)
    dg.save()
    dg.close()

    dg2 = DiskGraph(str(tmp_path / "dg"), fmt="parquet")
    def boom(*a, **kw):
        raise AssertionError("recalibration oracle scan ran on reopen")
    dg2.graph._host_oracle_slots = boom
    ef2, rec2 = dg2.graph.calibrate_ef(0.9, k=k)
    assert (ef2, rec2) == (ef, rec)
    dg2.close()


def test_hybrid_and_ivf_calibration_state_roundtrip():
    """HybridIndex/IVFIndex calibration snapshots restore the route
    table and auto-nprobe without re-measuring."""
    from hnsw_tpu.index.hybrid import HybridIndex
    from hnsw_tpu.index.ivf import IVFIndex

    n, d, k = 400, 16, 5
    v = make_vectors(n, d, seed=92)
    q = make_vectors(8, d, seed=93)

    ivf = IVFIndex(num_partitions=8, nprobe="auto", metric="cosine",
                   seed=0, auto_recall=0.8)
    ivf.build(list(range(n)), v)
    ivf.batch_search(q, k)                      # triggers calibration
    st = ivf.calibration_state()
    assert st.get("auto_nprobe")

    ivf2 = IVFIndex(num_partitions=8, nprobe="auto", metric="cosine",
                    seed=0, auto_recall=0.8)
    ivf2.build(list(range(n)), v)
    ivf2.restore_calibration(st)
    def boom(*a, **kw):
        raise AssertionError("auto-nprobe recalibrated after restore")
    ivf2._calibrate_nprobe = boom
    assert ivf2._resolve_nprobe() == st["auto_nprobe"][0]

    hi = HybridIndex(exact_threshold=10)        # force past exact tier
    hi.batch_add(list(range(n)), v)
    hi.batch_search(q, k, target_recall=0.9)    # calibrates a route
    hst = hi.calibration_state()
    assert hst["routes"]

    hi2 = HybridIndex(exact_threshold=10)
    hi2.batch_add(list(range(n)), v)
    hi2.restore_calibration(hst)
    kk2, t2 = next(iter(hi2._calib.items()))
    kk1, t1 = next(iter(hi._calib.items()))
    assert kk1 == kk2 and t1 == t2
