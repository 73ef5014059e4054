"""ExactIndex tests — ground-truth correctness, mutation, chunked path."""

import numpy as np
import pytest

from hnsw_tpu.index.exact import ExactIndex
from hnsw_tpu.ops.topk import np_exact_topk
from tests.conftest import make_vectors


def test_exact_search_matches_numpy_oracle():
    v = make_vectors(200, 32, seed=4)
    idx = ExactIndex(metric="cosine")
    idx.batch_add(list(range(200)), v)
    q = make_vectors(7, 32, seed=5)
    keys, dists = idx.batch_search(q, 10)
    gt_d, gt_i = np_exact_topk(q, v, 10, "cosine")
    for qi in range(7):
        assert [int(k) for k in keys[qi]] == list(gt_i[qi])
        np.testing.assert_allclose(dists[qi], gt_d[qi], rtol=1e-4, atol=1e-4)


def test_exact_chunked_path():
    from hnsw_tpu.ops.topk import exact_topk
    import jax.numpy as jnp
    v = make_vectors(1000, 16, seed=6)
    q = make_vectors(4, 16, seed=7)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    valid = np.ones(1000, bool)
    d_c, i_c = exact_topk(jnp.asarray(q), jnp.asarray(v), jnp.asarray(sq),
                          jnp.asarray(valid), k=5, metric="l2", chunk=128)
    gt_d, gt_i = np_exact_topk(q, v, 5, "l2")
    np.testing.assert_array_equal(np.asarray(i_c), gt_i)
    np.testing.assert_allclose(np.asarray(d_c), gt_d, rtol=1e-4, atol=1e-4)


def test_delete_and_reuse():
    v = make_vectors(20, 8, seed=8)
    idx = ExactIndex()
    idx.batch_add([f"k{i}" for i in range(20)], v)
    assert len(idx) == 20
    assert idx.delete("k3")
    assert not idx.delete("k3")
    assert len(idx) == 19
    keys, _ = idx.batch_search(v[3:4], 20)
    assert "k3" not in keys[0]
    # Slot reuse: add a new key, search still consistent.
    idx.add("fresh", v[3])
    keys, d = idx.batch_search(v[3:4], 1)
    assert keys[0][0] == "fresh"
    assert d[0][0] < 1e-5


def test_duplicate_key_replaces():
    idx = ExactIndex()
    idx.add(1, np.ones(4, np.float32))
    idx.add(1, -np.ones(4, np.float32))
    assert len(idx) == 1
    res = idx.search(-np.ones(4, np.float32), 1)
    assert res[0][0] == 1 and res[0][1] < 1e-5


def test_dim_mismatch_raises():
    idx = ExactIndex()
    idx.add(1, np.ones(4, np.float32))
    with pytest.raises(ValueError, match="dimension mismatch"):
        idx.add(2, np.ones(5, np.float32))


def test_empty_and_k_validation():
    idx = ExactIndex()
    with pytest.raises(ValueError, match="k must be greater than 0"):
        idx.batch_search_slots(np.zeros((1, 4), np.float32), 0)
    keys, d = idx.batch_search(np.zeros((2, 4), np.float32), 3)
    assert keys == [[None] * 3, [None] * 3]


def test_k_larger_than_n():
    v = make_vectors(3, 4, seed=9)
    idx = ExactIndex()
    idx.batch_add([0, 1, 2], v)
    res = idx.search(v[0], 10)
    assert len(res) == 3


def test_fast_math_matches_f32_oracle():
    """bf16 scan + f32 rerank must agree with the f32 oracle (>=0.999)."""
    import numpy as np
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.ops.topk import np_exact_topk
    from tests.conftest import make_vectors
    n, d, k = 4000, 64, 10
    v = make_vectors(n, d, seed=110)
    q = make_vectors(200, d, seed=111)
    idx = ExactIndex(metric="cosine", fast_math=True)
    idx.batch_add(list(range(n)), v)
    keys, dists = idx.batch_search(q, k)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    hits = sum(len(set(keys[i]) & set(map(int, gt_i[i])))
               for i in range(len(q)))
    recall = hits / (len(q) * k)
    assert recall >= 0.999, recall
    # reranked distances are f32-exact for the returned ids
    np.testing.assert_allclose(dists[:, 0], gt_d[:, 0], atol=1e-5)


def test_pallas_k_above_32_interpret():
    """k in (32, 128] supported by the fused kernel (interpret mode)."""
    import numpy as np
    import jax.numpy as jnp
    from hnsw_tpu.ops.pallas_exact import exact_topk_fused
    from hnsw_tpu.ops.topk import np_exact_topk
    from tests.conftest import make_vectors
    n, d, k = 2048, 32, 64
    v = make_vectors(n, d, seed=112)
    q = make_vectors(16, d, seed=113)
    sq = np.sum(v.astype(np.float64) * v, axis=1).astype(np.float32)
    d_, i_ = exact_topk_fused(jnp.asarray(q), jnp.asarray(v),
                              jnp.asarray(sq),
                              jnp.ones((n,), bool), k=k, metric="cosine",
                              interpret=True)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    assert np.array_equal(np.asarray(i_), gt_i)

def test_fast_math_does_not_resurrect_masked_rows():
    """Review regression: the widened top-k returns masked-out (dead/
    filtered) rows as INF fillers with VALID indices; the f32 rerank
    must not recompute their true distances and re-admit them."""
    import jax.numpy as jnp
    import numpy as np

    from hnsw_tpu.ops.topk import exact_topk
    from tests.conftest import make_vectors

    n, d, k = 500, 16, 5
    v = make_vectors(n, d, seed=95)
    sq = np.sum(v * v, axis=1)
    alive = np.zeros(n, bool)
    allowed = [100, 200, 300]
    alive[allowed] = True
    q = v[200][None]
    for fast in (False, True):
        dd, ii = exact_topk(jnp.asarray(q), jnp.asarray(v),
                            jnp.asarray(sq), jnp.asarray(alive),
                            k=k, metric="cosine", fast_math=fast)
        ii = np.asarray(ii)[0]
        got = {int(x) for x in ii if x >= 0}
        assert got <= set(allowed), (fast, ii)
        assert int(ii[0]) == 200


@pytest.mark.parametrize("hbm_dtype", ["bf16", "fp16", "int8"])
def test_capacity_mode_matches_oracle(hbm_dtype):
    """hbm_dtype stores the device table reduced-precision; the f32
    host rerank must restore exact ordering and exact distances for
    the returned keys (random data; int8's global per-row scale ranks
    spread-out data fine — clustered data is the documented exception,
    core/state._int8_block_fit physics)."""
    n, d, k = 3000, 32, 10
    v = make_vectors(n, d, seed=50)
    q = make_vectors(64, d, seed=51)
    idx = ExactIndex(metric="cosine", hbm_dtype=hbm_dtype)
    idx.batch_add(list(range(n)), v)
    idx.host_serve_max_batch = 0     # force the device capacity path
    keys, dists = idx.batch_search(q, k)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    rec = np.mean([len(set(keys[r]) & set(gt_i[r])) / k
                   for r in range(len(q))])
    floor = 0.95 if hbm_dtype == "int8" else 0.99
    assert rec >= floor, f"{hbm_dtype} recall {rec}"
    # distances for returned keys are EXACT f32 (host rerank), so any
    # key shared with the oracle must carry the oracle's distance
    for r in range(8):
        gmap = {int(i): float(dd) for i, dd in zip(gt_i[r], gt_d[r])}
        for kk_, dd in zip(keys[r], dists[r]):
            if kk_ in gmap:
                np.testing.assert_allclose(dd, gmap[kk_], rtol=1e-4)


def test_capacity_mode_delete_and_dead_rows():
    n, d, k = 500, 16, 5
    v = make_vectors(n, d, seed=52)
    idx = ExactIndex(metric="l2", hbm_dtype="int8")
    idx.batch_add(list(range(n)), v)
    idx.host_serve_max_batch = 0
    for dead in range(0, 100):
        idx.delete(dead)
    keys, dists = idx.batch_search(v[:32], k)
    flat = {kk for row in keys for kk in row}
    assert not (flat & set(range(100))), "deleted keys returned"
    # self-NN for live rows survives quantization + rerank
    keys2, d2 = idx.batch_search(v[200:208], 1)
    assert [row[0] for row in keys2] == list(range(200, 208))
    assert np.all(np.asarray(d2) < 1e-3)


def test_capacity_mode_auto_resolves_by_data():
    """hbm_dtype="auto" walks the fidelity ladder int8 -> bf16 -> fp16
    -> float32: spread-out data keeps int8; clustered data falls to the
    first rung that can rank it.  fp16 costs bf16's bytes with ~8x the
    mantissa resolution, so tight clusters that defeat bf16 (measured
    0.19 recall with rerank) stop there instead of paying f32 capacity;
    only EXTREMELY tight clusters (separations below fp16's spacing)
    must resolve float32."""
    rng = np.random.default_rng(7)
    n, d = 4000, 32
    idx = ExactIndex(metric="cosine", hbm_dtype="auto")
    idx.batch_add(list(range(n)),
                  rng.standard_normal((n, d)).astype(np.float32))
    idx.host_serve_max_batch = 0
    idx.batch_search(rng.standard_normal((4, d)).astype(np.float32), 5)
    assert idx._resolved_hbm == "int8"

    centers = rng.standard_normal((40, d)).astype(np.float32) * 5
    resolved = []
    # floor=None for the extreme case: within-cluster cosine distances
    # at jitter 0.002 are ~1e-7 — below f32's OWN cancellation noise in
    # 1 - cos near 1.0 — so top-10 membership is tie-dominated even at
    # the top rung; only the ladder decision is well-defined there.
    for jitter, floor in ((0.3, 0.95), (0.05, 0.99), (0.002, None)):
        data = (centers[rng.integers(0, 40, n)]
                + jitter * rng.standard_normal((n, d)).astype(np.float32))
        idx2 = ExactIndex(metric="cosine", hbm_dtype="auto")
        idx2.batch_add(list(range(n)), data)
        idx2.host_serve_max_batch = 0
        q = (centers[rng.integers(0, 40, 32)]
             + jitter * rng.standard_normal((32, d)).astype(np.float32))
        keys, _ = idx2.batch_search(q, 10)
        assert idx2._resolved_hbm != "int8", (jitter, idx2._resolved_hbm)
        if floor is not None:
            gt_d, gt_i = np_exact_topk(q, data, 10, "cosine")
            rec = np.mean([len(set(keys[r]) & set(gt_i[r])) / 10
                           for r in range(32)])
            assert rec >= floor, f"jitter {jitter}: recall {rec} "                 f"(resolved {idx2._resolved_hbm})"
        resolved.append(idx2._resolved_hbm)
    # the rank-10 boundary inside a ~100-point cluster separates by a
    # small FRACTION of the jitter scale, so each rung gives out well
    # before jitter reaches its stored-value spacing: at coordinate
    # magnitudes ~5-15, bf16 (~0.04 spacing) already fails the 0.99
    # containment fit at jitter 0.3 where fp16 (~0.004) still ranks;
    # by jitter 0.05 even fp16 drowns and the data pays f32 capacity
    assert resolved[0] == "fp16", resolved
    assert resolved[1] == "float32", resolved
    assert resolved[2] == "float32", resolved


def test_capacity_auto_recheck_on_data_replacement():
    """Replacing the data at the same N must re-run the fit check —
    the n-based cache alone false-passed when clustered data replaced
    random data (the Graph block-fit lesson, d67244e)."""
    rng = np.random.default_rng(9)
    n, d = 2000, 32
    idx = ExactIndex(metric="cosine", hbm_dtype="auto")
    idx.batch_add(list(range(n)),
                  rng.standard_normal((n, d)).astype(np.float32))
    idx.host_serve_max_batch = 0
    idx.batch_search(rng.standard_normal((4, d)).astype(np.float32), 5)
    assert idx._resolved_hbm == "int8"
    centers = rng.standard_normal((20, d)).astype(np.float32) * 5
    clustered = (centers[rng.integers(0, 20, n)]
                 + 0.05 * rng.standard_normal((n, d)).astype(np.float32))
    idx.batch_add(list(range(n)), clustered)   # same keys, new vectors
    idx.batch_search(rng.standard_normal((4, d)).astype(np.float32), 5)
    assert idx._resolved_hbm == "float32", idx._resolved_hbm


def test_batch_search_stream_matches_sequential():
    """The pipelined stream must return exactly what per-batch
    batch_search_slots returns, in order, for every hbm mode."""
    n, d, k = 2000, 32, 10
    v = make_vectors(n, d, seed=70)
    batches = [make_vectors(48, d, seed=71 + i) for i in range(4)]
    for dt in ("float32", "bf16", "int8"):
        idx = ExactIndex(metric="cosine", hbm_dtype=dt)
        idx.batch_add(list(range(n)), v)
        idx.host_serve_max_batch = 0
        seq = [idx.batch_search_slots(q, k) for q in batches]
        got = list(idx.batch_search_stream(batches, k))
        assert len(got) == len(seq)
        for (ds, is_), (dg, ig) in zip(seq, got):
            np.testing.assert_array_equal(is_, ig)
            np.testing.assert_allclose(ds, dg, rtol=1e-6)
    # empty index yields empty results without erroring
    empty = ExactIndex(metric="cosine", hbm_dtype="int8")
    out = list(empty.batch_search_stream(batches[:1], k))
    assert out[0][1].shape == (48, k) and (out[0][1] == -1).all()


@pytest.mark.parametrize("metric", ["dot", "sqeuclidean"])
def test_capacity_mode_other_metrics(metric):
    n, d, k = 1500, 24, 5
    v = make_vectors(n, d, seed=80)
    q = make_vectors(32, d, seed=81)
    idx = ExactIndex(metric=metric, hbm_dtype="int8")
    idx.batch_add(list(range(n)), v)
    idx.host_serve_max_batch = 0
    keys, dists = idx.batch_search(q, k)
    gt_d, gt_i = np_exact_topk(q, v, k, metric)
    rec = np.mean([len(set(keys[r]) & set(gt_i[r])) / k
                   for r in range(32)])
    assert rec >= 0.95, f"{metric} capacity recall {rec}"
    np.testing.assert_allclose(
        np.asarray(dists)[:, 0], gt_d[:, 0], rtol=1e-3, atol=1e-3)
