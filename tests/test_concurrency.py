"""Concurrency contract.

The reference serves concurrent Search under sync.RWMutex
(/root/reference/graph.go:328) and proves it with goroutine storms
(/root/reference/graph_test.go:461-527). Equivalent contract here:
Graph mutations take the write side of utils.rwlock.RWLock, searches
the read side — one process may mutate while other threads search.
"""
import threading
import time

import numpy as np
import pytest

from hnsw_tpu.index.hnsw import Graph
from hnsw_tpu.utils.rwlock import RWLock


def make_vectors(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


# ---- lock primitives ---------------------------------------------------------

def test_rwlock_reentrancy_shapes():
    rw = RWLock()
    # reentrant reads
    with rw.read():
        with rw.read():
            pass
    # reentrant writes
    with rw.write():
        with rw.write():
            pass
        # read inside own write
        with rw.read():
            pass
    # upgrade refused loudly
    with rw.read():
        with pytest.raises(RuntimeError, match="upgrade"):
            rw.acquire_write()


def test_rwlock_writer_excludes_readers():
    rw = RWLock()
    order = []
    rw.acquire_write()

    def reader():
        with rw.read():
            order.append("read")

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.05)
    order.append("write-done")
    rw.release_write()
    t.join(5)
    assert order == ["write-done", "read"]


def test_rwlock_readers_share():
    rw = RWLock()
    n_inside = []
    barrier = threading.Barrier(4, timeout=10)

    def reader():
        with rw.read():
            barrier.wait()      # all 4 hold the read side AT ONCE
            n_inside.append(1)

    ts = [threading.Thread(target=reader) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert len(n_inside) == 4


def test_rwlock_queued_writer_does_not_deadlock_nested_read():
    """A thread already holding a read must be able to re-acquire it
    even while a writer waits — the classic RW deadlock this lock's
    per-thread depth tracking exists to prevent."""
    rw = RWLock()
    done = []
    rw.acquire_read()
    w = threading.Thread(target=lambda: (rw.acquire_write(),
                                         rw.release_write(),
                                         done.append("w")))
    w.start()
    time.sleep(0.05)           # writer is now queued
    with rw.read():            # nested read MUST not block
        done.append("nested")
    rw.release_read()
    w.join(5)
    assert done == ["nested", "w"]


# ---- graph storm -------------------------------------------------------------

def test_concurrent_add_search_storm():
    """graph_test.go:461-527's storm, threaded: one writer mutates
    (adds + deletes, including full in-edge sweeps) while reader
    threads hammer search/batch_search. Every result must be
    well-formed; the final graph must serve every live key."""
    n0, d, k = 400, 16, 5
    data = make_vectors(n0 + 400, d, seed=1)
    g = Graph(m=8, metric="cosine", seed=0)
    g.batch_add(list(range(n0)), data[:n0])

    errors = []
    stop = threading.Event()

    def reader(tid):
        rng = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                q = data[rng.integers(0, n0)]
                res = g.search(q, k)
                assert 0 < len(res) <= k
                assert all(isinstance(dd, float) for _, dd in res)
                qs = data[rng.integers(0, n0, 4)]
                keys, dists = g.batch_search(qs, k)
                assert len(keys) == 4
        except Exception as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    readers = [threading.Thread(target=reader, args=(t,))
               for t in range(4)]
    for t in readers:
        t.start()
    try:
        for w0 in range(n0, n0 + 400, 50):
            g.batch_add(list(range(w0, w0 + 50)), data[w0:w0 + 50])
            g.batch_delete(list(range(w0 - n0, w0 - n0 + 10)))
    finally:
        stop.set()
        for t in readers:
            t.join(30)
    assert not errors, errors[:3]
    # post-storm consistency: live keys all served, dead keys absent
    dead = set(range(0, 400, 50)) | set()
    live_checked = 0
    for kk in range(n0 + 300, n0 + 400):
        res = g.search(data[kk], 1)
        assert res[0][0] == kk, (kk, res)
        live_checked += 1
    assert live_checked == 100
    g.validate()


def test_rwlock_writer_priority_beats_read_storm():
    """A queued writer must acquire even under a continuous read storm
    (the reference RWMutex's writer priority). Without the priority
    gate, spinning readers starved batch_add indefinitely on a
    contended single-core host."""
    rw = RWLock()
    stop = threading.Event()
    got_write = threading.Event()

    def reader():
        while not stop.is_set():
            with rw.read():
                pass

    ts = [threading.Thread(target=reader) for _ in range(3)]
    for t in ts:
        t.start()
    time.sleep(0.05)           # storm established

    def writer():
        with rw.write():
            got_write.set()

    w = threading.Thread(target=writer)
    w.start()
    ok = got_write.wait(10)
    stop.set()
    w.join(5)
    for t in ts:
        t.join(5)
    assert ok, "writer starved by read storm"


def test_exact_latency_tier_concurrent_readers():
    """The pre-marshalled PreparedScan object is shared by concurrent
    single-query readers (fixed args immutable, outputs allocated per
    call) — a reader storm must return exact results throughout."""
    import threading

    from hnsw_tpu.index.exact import ExactIndex

    n, d, k = 4096, 128, 5
    rng = np.random.default_rng(21)
    docs = rng.standard_normal((n, d)).astype(np.float32)
    ex = ExactIndex(metric="cosine")
    ex.batch_add(list(range(n)), docs)
    ex.search(docs[0], k)          # build sidecar + prepared call once

    errs = []

    def storm(tid):
        try:
            for i in range(50):
                qi = (tid * 50 + i) % n
                res = ex.search(docs[qi], k)
                assert res[0][0] == qi and res[0][1] < 1e-5, (qi, res[0])
        except Exception as e:      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=storm, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
