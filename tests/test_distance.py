"""Distance op tests — pin the metric semantics against scipy-free numpy
oracles, mirroring the reference's distance_test.go coverage."""

import numpy as np
import pytest

from hnsw_tpu.ops.distance import (np_pairwise_dist, pairwise_dist,
                                   point_dist, sq_norms)
from tests.conftest import make_vectors


def _ref_cosine(a, b):
    return 1.0 - np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
def test_pairwise_matches_pointwise(metric):
    v = make_vectors(32, 24, seed=1)
    q = make_vectors(5, 24, seed=2)
    d = np.asarray(pairwise_dist(q, v, metric=metric))
    dn = np_pairwise_dist(q, v, metric)
    np.testing.assert_allclose(d, dn, rtol=1e-4, atol=1e-4)
    for i in range(3):
        for j in range(4):
            np.testing.assert_allclose(
                d[i, j], point_dist(q[i], v[j], metric), rtol=1e-4, atol=1e-4)


def test_cosine_semantics():
    a = np.array([1.0, 0.0, 0.0], np.float32)
    b = np.array([0.0, 1.0, 0.0], np.float32)
    assert abs(point_dist(a, a, "cosine")) < 1e-6
    assert abs(point_dist(a, b, "cosine") - 1.0) < 1e-6
    assert abs(point_dist(a, -a, "cosine") - 2.0) < 1e-6
    va = make_vectors(8, 16, seed=3)
    for i in range(8):
        ref = _ref_cosine(va[0].astype(np.float64), va[i].astype(np.float64))
        assert abs(point_dist(va[0], va[i], "cosine") - ref) < 1e-5


def test_l2_semantics():
    a = np.array([0.0, 0.0], np.float32)
    b = np.array([3.0, 4.0], np.float32)
    assert abs(point_dist(a, b, "l2") - 5.0) < 1e-6
    assert abs(point_dist(a, b, "sqeuclidean") - 25.0) < 1e-6


def test_euclidean_alias():
    v = make_vectors(4, 8)
    d1 = np_pairwise_dist(v, v, "euclidean")
    d2 = np_pairwise_dist(v, v, "l2")
    np.testing.assert_array_equal(d1, d2)


def test_zero_vector_cosine_no_nan():
    # The reference lets zero vectors produce NaN (graph.go:65-66 comment);
    # we deliberately guard with an epsilon so device top-k stays well
    # ordered.
    z = np.zeros((1, 4), np.float32)
    v = make_vectors(3, 4)
    d = np.asarray(pairwise_dist(z, v, metric="cosine"))
    assert np.all(np.isfinite(d))


def test_sq_norms():
    v = make_vectors(10, 7)
    np.testing.assert_allclose(np.asarray(sq_norms(v)),
                               np.sum(v * v, axis=1), rtol=1e-5)


# ------------------------------------------------- custom distance end-to-end

def _register_manhattan():
    import jax.numpy as jnp

    from hnsw_tpu.ops.distance import _registry, register_distance
    if "manhattan" in _registry:
        return

    def point_fn(a, b):
        return float(np.abs(np.asarray(a, np.float32)
                            - np.asarray(b, np.float32)).sum())

    def pairwise_fn(q, v):
        return jnp.sum(jnp.abs(q[:, None, :] - v[None, :, :]), axis=-1)

    register_distance("manhattan", point_fn, pairwise_fn)


def test_custom_metric_usable_in_graph_and_exact(tmp_path):
    """registered metrics work end-to-end — Graph build
    + search + checkpoint round-trip + ExactIndex, with recall measured
    against the metric's own oracle (reference: pluggable DistanceFunc,
    distance.go:12,44; vectortypes/types.go:18)."""
    _register_manhattan()
    from hnsw_tpu import Graph
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.io.codec import load_graph, save_graph
    from hnsw_tpu.ops.distance import np_pairwise_dist

    n, d, k = 400, 16, 5
    v = make_vectors(n, d, seed=95)
    q = make_vectors(30, d, seed=96)
    # own-oracle ground truth under L1
    dm = np_pairwise_dist(q, v, "manhattan")
    gt = np.argsort(dm, axis=1, kind="stable")[:, :k]

    # ExactIndex must be exact under the custom metric
    ex = ExactIndex(metric="manhattan")
    ex.batch_add(list(range(n)), v)
    keys, dists = ex.batch_search(q, k)
    hits = sum(len(set(keys[i]) & set(map(int, gt[i]))) for i in range(30))
    assert hits == 30 * k

    # Graph builds and searches under the custom metric
    g = Graph(metric="manhattan", seed=0, ef_construction=80)
    g.batch_add(list(range(n)), v)
    keys, dists = g.batch_search(q, k, ef=64)
    hits = sum(len(set(keys[i]) & set(map(int, gt[i]))) for i in range(30))
    recall = hits / (30 * k)
    assert recall >= 0.9, f"graph recall {recall} under custom metric"
    # reported distances match the metric's own point function
    res = g.search(v[17], 1)
    assert res[0][0] == 17 and res[0][1] < 1e-4

    # checkpoint round-trip preserves the metric by NAME
    p = str(tmp_path / "g.npz")
    save_graph(g, p)
    g2 = load_graph(p)
    assert g2.metric == "manhattan"
    keys2, _ = g2.batch_search(q, k, ef=64)
    assert [list(r) for r in keys2] == [list(r) for r in keys]


def test_unregistered_metric_rejected(tmp_path):
    from hnsw_tpu import Graph
    with pytest.raises(ValueError, match="unknown metric"):
        Graph(metric="no-such-metric")


def test_custom_metric_without_pairwise_fn_is_host_only():
    from hnsw_tpu.ops.distance import (np_pairwise_dist, point_dist,
                                       register_distance)
    register_distance("chebyshev-host",
                      lambda a, b: float(np.max(np.abs(a - b))))
    a = np.array([1.0, 2.0], np.float32)
    b = np.array([4.0, 0.0], np.float32)
    assert point_dist(a, b, "chebyshev-host") == 3.0
    d = np_pairwise_dist(a[None], b[None], "chebyshev-host")
    assert d.shape == (1, 1) and d[0, 0] == 3.0
    # device search without a pairwise_fn gives a clear error
    from hnsw_tpu import Graph
    g = Graph(metric="chebyshev-host")
    with pytest.raises(ValueError, match="pairwise_fn"):
        g.batch_add([0, 1], np.stack([a, b]))
        g.search(a, 1)


def test_cannot_override_builtin():
    from hnsw_tpu.ops.distance import register_distance
    with pytest.raises(ValueError, match="builtin"):
        register_distance("cosine", lambda a, b: 0.0)
