"""Fused exact scan + top-k kernel — correctness vs the numpy oracle.

The kernel is compiled for the card only through Pallas' Triton route;
here it runs in interpret mode on the CPU. ``test_fused_compiled_on_gpu``
runs it compiled where a GPU exists (``chip_smoke.py`` phase 3 checks
the same on the card at 1,048,576 x 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_tpu.ops import pallas_exact
from hnsw_tpu.ops.pallas_exact import (exact_topk_fused, fused_applies,
                                       ksel_for, plan)
from hnsw_tpu.ops.topk import np_exact_topk
from tests.conftest import make_vectors


@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
def test_fused_matches_oracle(metric):
    n, d, q, k = 300, 32, 20, 10
    v = make_vectors(n, d, seed=110)
    qs = make_vectors(q, d, seed=111)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    dd, ii = exact_topk_fused(qs, v, jnp.asarray(sq),
                              jnp.ones(n, bool), k=k, metric=metric,
                              interpret=True)
    gt_d, gt_i = np_exact_topk(qs, v, k, metric)
    np.testing.assert_array_equal(np.asarray(ii), gt_i)
    np.testing.assert_allclose(np.asarray(dd), gt_d, rtol=1e-4, atol=1e-4)


def test_fused_respects_validity_mask():
    n, d = 64, 16
    v = make_vectors(n, d, seed=112)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::2] = False
    dd, ii = exact_topk_fused(v[:4], v, jnp.asarray(sq),
                              jnp.asarray(valid), k=5, metric="l2",
                              interpret=True)
    ii = np.asarray(ii)
    assert np.all(ii % 2 == 1)  # only odd (valid) rows returned


def test_fused_k_exceeds_valid_count():
    v = make_vectors(16, 8, seed=113)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    valid = np.zeros(16, bool)
    valid[:3] = True
    dd, ii = exact_topk_fused(v[:2], v, jnp.asarray(sq),
                              jnp.asarray(valid), k=8, metric="cosine",
                              interpret=True)
    ii = np.asarray(ii)
    assert set(ii[0][ii[0] >= 0].tolist()) == {0, 1, 2}
    assert np.all(ii[:, 3:] == -1)


@pytest.mark.parametrize("q,n,d", [(1, 130, 17), (70, 1000, 100),
                                   (65, 257, 128)])
def test_fused_pads_ragged_shapes(q, n, d):
    """Q, N and D that are not multiples of the tiles: the wrapper pads
    queries, rows (as masked) and dimensions (with zeros)."""
    v = make_vectors(n, d, seed=114)
    qs = make_vectors(q, d, seed=115)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    for fast in (False, True):
        dd, ii = exact_topk_fused(qs, v, jnp.asarray(sq),
                                  jnp.ones(n, bool), k=10, metric="l2",
                                  interpret=True, fast_math=fast)
        gt_d, gt_i = np_exact_topk(qs, v, 10, "l2")
        assert np.asarray(ii).shape == (q, 10)
        np.testing.assert_array_equal(np.asarray(ii), gt_i)
        np.testing.assert_allclose(np.asarray(dd), gt_d, rtol=1e-4,
                                   atol=1e-4)


def test_fused_k_exceeds_row_count():
    """k larger than N: the tail is INF_DIST / -1."""
    v = make_vectors(12, 16, seed=116)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    dd, ii = exact_topk_fused(v[:3], v, jnp.asarray(sq),
                              jnp.ones(12, bool), k=20, metric="l2",
                              interpret=True)
    ii = np.asarray(ii)
    assert all(sorted(row[:12].tolist()) == list(range(12)) for row in ii)
    assert np.all(ii[:, 12:] == -1)
    assert np.all(np.asarray(dd)[:, 12:] >= 3e38)


def test_fused_rejects_unsupported():
    v = jnp.ones((32, 16), jnp.float32)
    sq = jnp.ones((32,), jnp.float32)
    ok = jnp.ones((32,), bool)
    with pytest.raises(ValueError, match="metric"):
        exact_topk_fused(v[:2], v, sq, ok, k=5, metric="hamming",
                         interpret=True)
    with pytest.raises(ValueError, match="supports k"):
        exact_topk_fused(v[:2], v, sq, ok, k=200, metric="l2",
                         interpret=True)


def test_plan_tiles_and_splits():
    """Padded shapes are whole tiles; N splits grow until the grid has
    about two blocks per SM, and never beyond one tile per split."""
    TQ, TC = pallas_exact.TQ, pallas_exact.TC
    for n_q, n, d in ((8192, 1 << 20, 128), (1024, 1 << 20, 128),
                      (1, 100, 7), (300, 5000, 100)):
        q_pad, d_pad, splits, n_pad = plan(n_q, n, d)
        assert q_pad % TQ == 0 and q_pad >= n_q > q_pad - TQ
        assert d_pad >= max(d, 16) and d_pad & (d_pad - 1) == 0
        assert splits & (splits - 1) == 0
        assert n_pad % (splits * TC) == 0 and n_pad >= n
        assert n_pad // splits >= TC
    # B = 1024 fills the card through N splits; B = 8192 needs fewer
    assert plan(1024, 1 << 20, 128)[2] > plan(8192, 1 << 20, 128)[2]


def test_ksel_margin():
    for k in (1, 10, 26, 58, 122):
        ks = ksel_for(k)
        assert ks >= k + 6 and ks & (ks - 1) == 0


@pytest.mark.parametrize("platform,n,k,metric,want", [
    ("gpu", 1 << 20, 10, "l2", True),
    ("gpu", 1 << 20, 10, "cosine", True),
    ("gpu", pallas_exact.FUSED_MIN_ROWS, 10, "dot", True),
    ("gpu", pallas_exact.FUSED_MIN_ROWS - 1, 10, "l2", False),
    ("gpu", 1 << 20, 200, "l2", False),
    ("cpu", 1 << 20, 10, "l2", False),
])
def test_kernel_choice(platform, n, k, metric, want):
    assert fused_applies(platform, n, k, metric) is want


@pytest.mark.gpu
def test_fused_compiled_on_gpu(gpu_device):
    n, d, q, k = 70000, 128, 256, 10
    v = make_vectors(n, d, seed=117)
    qs = make_vectors(q, d, seed=118)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    gt_d, gt_i = np_exact_topk(qs, v, k, "l2")
    for fast in (False, True):
        dd, ii = exact_topk_fused(qs, v, jnp.asarray(sq),
                                  jnp.ones(n, bool), k=k, metric="l2",
                                  fast_math=fast)
        rec = np.mean([len(set(np.asarray(ii)[r]) & set(gt_i[r])) / k
                       for r in range(q)])
        assert rec >= (0.99 if fast else 0.999), (fast, rec)
