"""Determinism & invariance tests.

The reference's thread-safety storms (graph_test.go:461,
graph_benchmark_test.go:123) defend against data races; the functional
device engine replaces them with determinism guarantees (SURVEY.md §4):
identical results across runs, batch compositions, and shardings.
"""

import numpy as np

from hnsw_tpu import Graph
from tests.conftest import make_vectors


def test_search_batch_composition_invariant():
    v = make_vectors(400, 16, seed=100)
    g = Graph(seed=0)
    g.batch_add(list(range(400)), v)
    q = make_vectors(32, 16, seed=101)
    # full batch
    keys_full, d_full = g.batch_search(q, 5, ef=40)
    # singles
    for i in (0, 7, 31):
        keys_one, d_one = g.batch_search(q[i:i + 1], 5, ef=40)
        assert keys_one[0] == keys_full[i]
        np.testing.assert_allclose(d_one[0], d_full[i], rtol=1e-5)
    # shuffled batch
    perm = np.random.default_rng(3).permutation(32)
    keys_p, d_p = g.batch_search(q[perm], 5, ef=40)
    for j, i in enumerate(perm):
        assert keys_p[j] == keys_full[i]


def test_repeated_search_identical():
    v = make_vectors(300, 16, seed=102)
    g = Graph(seed=0)
    g.batch_add(list(range(300)), v)
    q = make_vectors(8, 16, seed=103)
    k1, d1 = g.batch_search(q, 7, ef=30)
    k2, d2 = g.batch_search(q, 7, ef=30)
    assert k1 == k2
    np.testing.assert_array_equal(d1, d2)


def test_bulk_build_deterministic():
    v = make_vectors(500, 16, seed=104)
    g1 = Graph(seed=11)
    g1.build(list(range(500)), v, wave=128)
    g2 = Graph(seed=11)
    g2.build(list(range(500)), v, wave=128)
    np.testing.assert_array_equal(g1.host.neighbors, g2.host.neighbors)
    np.testing.assert_array_equal(g1.host.levels, g2.host.levels)
    assert g1.host.entry == g2.host.entry


def test_mixed_ops_stay_consistent():
    # add/delete/search interleaving (the reference's mixed-op fuzz,
    # deterministic here)
    rng = np.random.default_rng(105)
    v = rng.standard_normal((600, 12)).astype(np.float32)
    g = Graph(seed=0)
    live = set()
    for i in range(300):
        g.add(i, v[i])
        live.add(i)
    for step in range(150):
        op = step % 5
        if op in (0, 1) and len(live) < 600:
            nxt = max(live) + 1 if live else 0
            if nxt < 600:
                g.add(nxt, v[nxt])
                live.add(nxt)
        elif op == 2 and len(live) > 10:
            victim = min(live)
            assert g.delete(victim)
            live.discard(victim)
        else:
            q = rng.standard_normal(12).astype(np.float32)
            res = g.search(q, 5)
            assert all(k in live for k, _ in res)
    assert len(g) == len(live)


def test_hash_visited_path_large_cap():
    # cap >= 65536 flips beam search to the direct-mapped visited table;
    # verify exact behavior on a synthetic 1-D line graph where true
    # nearest neighbors are known.
    import jax.numpy as jnp
    from hnsw_tpu.core.search import search_graph
    from hnsw_tpu.core.state import DeviceGraph

    cap, d, m = 65536, 8, 16
    # center coordinates at 0: the Gram-based l2 epilogue cancels
    # catastrophically when |x| ~ 1e4 (ulp of x^2 exceeds neighbor
    # separation) — standard property of the ||a||^2+||b||^2-2ab
    # formulation, not a search bug
    xs = np.arange(cap, dtype=np.float32) - cap // 2
    vecs = np.zeros((cap, d), np.float32)
    vecs[:, 0] = xs
    vecs[:, 1] = 1.0  # keep norms nonzero
    sq = np.sum(vecs * vecs, axis=1)
    # layer 0: connect to +-8 neighbors; layer 1: every 64th node
    # connects to +-8 strided neighbors
    nb = np.full((2, cap, m), -1, np.int32)
    offs = np.array([o for o in range(-8, 9) if o != 0][:m])
    rows_i = np.arange(cap, dtype=np.int64)
    idx = rows_i[:, None] + offs[None, :]
    np.clip(idx, 0, cap - 1, out=idx)
    nb[0] = idx
    coarse = np.arange(0, cap, 64)
    cidx = (coarse[:, None] + offs[None, :] * 64)
    np.clip(cidx, 0, cap - 1, out=cidx)
    nb[1, coarse] = cidx
    levels = np.zeros(cap, np.int32)
    levels[coarse] = 1
    g = DeviceGraph(vectors=jnp.asarray(vecs), sq_norms=jnp.asarray(sq),
                    neighbors=jnp.asarray(nb),
                    levels=jnp.asarray(levels),
                    alive=jnp.ones(cap, bool),
                    entry=jnp.asarray(np.int32(cap // 2)))
    rng = np.random.default_rng(7)
    targets = rng.integers(cap // 2 - 3000, cap // 2 + 3000, 16)
    q = np.zeros((16, d), np.float32)
    q[:, 0] = targets - cap // 2
    q[:, 1] = 1.0
    dists, ids = search_graph(g, jnp.asarray(q), k=5, ef=32,
                              metric="l2", max_hops=4096, expand=4)
    ids = np.asarray(ids)
    for i, t in enumerate(targets):
        assert ids[i, 0] == t, (t, ids[i])
        assert set(ids[i]).issubset(set(range(t - 8, t + 9)))


def test_random_op_fuzz_with_checkpoints(tmp_path):
    """Model-based fuzz: a seeded random interleaving of batch adds,
    duplicate overwrites, deletes, batch deletes, searches, and
    checkpoint round-trips must keep the graph consistent with a plain
    dict model at every step (extends test_mixed_ops_stay_consistent
    with bulk ops and mid-sequence persistence)."""
    from hnsw_tpu import load_graph, save_graph

    rng = np.random.default_rng(321)
    d = 10
    pool = rng.standard_normal((800, d)).astype(np.float32)
    g = Graph(seed=0)
    model = {}
    next_key = 0
    path = str(tmp_path / "fuzz.npz")
    for step in range(60):
        op = int(rng.integers(0, 6))
        if op == 0 and next_key < 700:      # batch add
            nb = int(rng.integers(1, 40))
            ks = list(range(next_key, min(next_key + nb, 700)))
            g.batch_add(ks, pool[ks])
            model.update({kk: kk for kk in ks})
            next_key = ks[-1] + 1
        elif op == 1 and model:             # duplicate overwrite
            kk = int(rng.choice(list(model)))
            g.add(kk, pool[(kk + 13) % 800])
            model[kk] = (kk + 13) % 800
        elif op == 2 and len(model) > 5:    # single delete
            kk = int(rng.choice(list(model)))
            assert g.delete(kk)
            del model[kk]
        elif op == 3 and len(model) > 20:   # batch delete
            ks = [int(x) for x in
                  rng.choice(list(model), size=5, replace=False)]
            out = g.batch_delete(ks)
            assert all(out)
            for kk in ks:
                del model[kk]
        elif op == 4 and model:             # checkpoint round-trip
            save_graph(g, path)
            g = load_graph(path)
        else:                               # search
            q = rng.standard_normal(d).astype(np.float32)
            res = g.search(q, 5)
            assert all(k in model for k, _ in res)
            assert len(res) == min(5, len(model))
        assert len(g) == len(model)
    # every surviving key resolves to its model vector and is its own NN
    for kk in list(model)[:20]:
        row = g.lookup(kk)
        np.testing.assert_allclose(row, pool[model[kk]], rtol=1e-6)
        hit = g.search(pool[model[kk]], 1)[0]
        assert hit[0] == kk and hit[1] < 1e-4
