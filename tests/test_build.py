"""Bulk batched construction tests — quality parity with sequential
insertion, the oracle pattern of parquet/graph_test.go:179
(TestParquetGraph_CompareWithInMemory, InDelta 0.1)."""

import numpy as np
import pytest

from hnsw_tpu import Graph
from hnsw_tpu.ops.topk import np_exact_topk
from tests.conftest import make_vectors


def _recall(keys, gt, k):
    hits = sum(len(set(map(int, keys[i][:k])) & set(map(int, gt[i][:k])))
               for i in range(len(gt)))
    return hits / (len(gt) * k)


def test_bulk_build_recall_parity_with_sequential():
    n, d, k = 800, 24, 10
    v = make_vectors(n, d, seed=40)
    q = make_vectors(40, d, seed=41)
    _, gt = np_exact_topk(q, v, k, "cosine")

    g_seq = Graph(seed=0)
    g_seq.batch_add(list(range(n)), v)
    g_bulk = Graph(seed=0)
    g_bulk.build(list(range(n)), v, wave=128)

    r_seq = _recall(g_seq.batch_search(q, k, ef=60)[0], gt, k)
    r_bulk = _recall(g_bulk.batch_search(q, k, ef=60)[0], gt, k)
    assert r_bulk >= r_seq - 0.1, (r_seq, r_bulk)
    assert r_bulk >= 0.85


def test_bulk_build_single_wave_and_small():
    v = make_vectors(50, 8, seed=42)
    g = Graph(seed=0)
    g.build(list(range(50)), v, wave=512)
    assert len(g) == 50
    res = g.search(v[13], 1)
    assert res[0][0] == 13


def test_bulk_build_incremental_waves_onto_existing():
    v = make_vectors(300, 16, seed=43)
    g = Graph(seed=0)
    g.build(list(range(200)), v[:200], wave=64)
    g.build(list(range(200, 300)), v[200:], wave=64)
    assert len(g) == 300
    q = make_vectors(20, 16, seed=44)
    _, gt = np_exact_topk(q, v, 5, "cosine")
    r = _recall(g.batch_search(q, 5, ef=60)[0], gt, 5)
    assert r >= 0.85
    # newly added nodes are findable
    assert g.search(v[250], 1)[0][0] == 250


def test_bulk_build_rejects_duplicates_in_batch():
    g = Graph(seed=0)
    with pytest.raises(ValueError, match="duplicate keys"):
        g.build([1, 1], np.ones((2, 4), np.float32))


def test_bulk_build_replaces_existing_keys():
    v = make_vectors(20, 8, seed=45)
    g = Graph(seed=0)
    g.build(list(range(20)), v)
    v2 = make_vectors(20, 8, seed=46)
    g.build(list(range(10)), v2[:10])
    assert len(g) == 20
    np.testing.assert_array_equal(g.lookup(3), v2[3])
    assert g.search(v2[3], 1)[0][0] == 3


def test_bulk_then_delete_then_search():
    v = make_vectors(200, 16, seed=47)
    g = Graph(seed=0)
    g.build(list(range(200)), v, wave=64)
    g.batch_delete(list(range(0, 200, 4)))
    assert len(g) == 150
    res = g.search(v[1], 1)
    assert res[0][0] == 1
    keys, _ = g.batch_search(v[:8], 5, ef=40)
    flat = [k for row in keys for k in row if k is not None]
    assert all(int(k) % 4 != 0 for k in flat)


def test_bulk_build_levels_geometric():
    v = make_vectors(600, 8, seed=48)
    g = Graph(seed=0)
    g.build(list(range(600)), v, wave=200)
    levels = g.host.levels[g.host.levels >= 0]
    sizes = [(levels >= l).sum() for l in range(g.num_layers)]
    assert sizes[0] == 600
    assert 0.1 < sizes[1] / sizes[0] < 0.45


def test_refine_preserves_and_improves():
    v = make_vectors(600, 24, seed=140)
    g = Graph(seed=0)
    g.build(list(range(600)), v, wave=128)
    q = make_vectors(30, 24, seed=141)
    _, gt = np_exact_topk(q, v, 10, "cosine")
    keys0, _ = g.batch_search(q, 10, ef=80)
    r0 = _recall(keys0, gt, 10)
    g.refine(wave=256)
    keys1, _ = g.batch_search(q, 10, ef=80)
    r1 = _recall(keys1, gt, 10)
    assert r1 >= r0 - 0.02  # never materially worse
    assert g.search(v[11], 1)[0][0] == 11


def test_scoped_refine_recovers_post_delete_recall():
    """delete-heavy workloads degrade recall under
    replenish-only repair; scoped refinement of affected neighborhoods
    recovers it (>= 0.95 of pre-delete recall)."""
    import numpy as np
    from hnsw_tpu import Graph
    from hnsw_tpu.ops.topk import np_exact_topk
    from tests.conftest import make_vectors

    n, d, k, ef = 1200, 32, 10, 96
    v = make_vectors(n, d, seed=93)
    q = make_vectors(64, d, seed=94)

    def recall(g, keep_mask):
        keys, _ = g.batch_search(q, k, ef=ef)
        live = np.flatnonzero(keep_mask)
        gt_d, gt_li = np_exact_topk(q, v[live], k, "cosine")
        gt = live[gt_li]
        hits = sum(len({kk for kk in keys[i] if kk is not None}
                       & set(map(int, gt[i]))) for i in range(len(q)))
        return hits / (len(q) * k)

    rng = np.random.default_rng(7)
    doomed = rng.choice(n, n // 4, replace=False)
    keep = np.ones(n, bool)
    keep[doomed] = False

    # replenish-only
    g1 = Graph(seed=0, ef_construction=100)
    g1.build(list(range(n)), v, method="device", wave=512)
    pre = recall(g1, np.ones(n, bool))
    g1.batch_delete([int(s) for s in doomed])
    post_plain = recall(g1, keep)

    # scoped refine
    g2 = Graph(seed=0, ef_construction=100)
    g2.build(list(range(n)), v, method="device", wave=512)
    g2.batch_delete([int(s) for s in doomed], refine=True)
    post_refined = recall(g2, keep)

    assert post_refined >= post_plain - 0.02, (post_plain, post_refined)
    assert post_refined >= 0.95 * pre, (pre, post_plain, post_refined)

def test_reverse_diversify_device_build():
    """GraphConfig.reverse_diversify: heuristic re-selection of rows hit
    by reverse edges in the device builder — recall stays within the
    parity band of the closest-deg default (the measured delta is nil)."""
    from hnsw_tpu.config import GraphConfig
    n, d, k = 800, 24, 10
    v = make_vectors(n, d, seed=50)
    q = make_vectors(40, d, seed=51)
    _, gt = np_exact_topk(q, v, k, "cosine")

    g0 = Graph(seed=0, ef_construction=100)
    g0.build(list(range(n)), v, method="device", wave=256)
    g1 = Graph(config=GraphConfig(seed=0, ef_construction=100,
                                  reverse_diversify=True))
    g1.build(list(range(n)), v, method="device", wave=256)

    r0 = _recall(g0.batch_search(q, k, ef=60)[0], gt, k)
    r1 = _recall(g1.batch_search(q, k, ef=60)[0], gt, k)
    assert r1 >= r0 - 0.1, (r0, r1)
    assert r1 >= 0.85

def test_block_m_narrow_blocks_build_and_serve():
    """block_m (the 2M+ HBM knob): quant-descent build with narrowed
    neighbor blocks keeps construction quality (edge selection rescores
    f32); serving with narrow blocks trades recall for block memory and
    the DeviceGraph reflects the narrower tensor."""
    from hnsw_tpu.ops.topk import np_exact_topk as _gt
    n, d, k = 700, 24, 10
    v = make_vectors(n, d, seed=60)
    q = make_vectors(32, d, seed=61)
    _, gt = _gt(q, v, k, "cosine")

    g = Graph(seed=0, ef_construction=100)
    g.build(list(range(n)), v, method="device", wave=256,
            quant_descent=True, block_m=8)
    r = _recall(g.batch_search(q, k, ef=80)[0], gt, k)
    assert r >= 0.85, r

    g.fast_math = True
    g.block_layout = True
    g.block_m = 8
    dev = g.device_graph()
    assert dev.nbr_blocks is not None and dev.nbr_blocks.shape[1] == 8
    keys, _ = g.batch_search(q, k, ef=80)
    assert _recall(keys, gt, k) >= 0.6  # capacity mode: narrower hops

def test_device_build_wave_clamped():
    """batch9 regression: the intra-wave kNN is O(W^2) HBM (4.3 GB at
    W=32768) — oversized waves are clamped with a warning, and the
    build still completes correctly."""
    import warnings
    n, d = 500, 16
    v = make_vectors(n, d, seed=80)
    g = Graph(seed=0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        g.build(list(range(n)), v, method="device", wave=32768)
    assert any("clamped" in str(x.message) for x in w)
    assert g.search(v[7], 1)[0][0] == 7


def test_fp16_descent_matches_f32_descent_quality():
    """descent_dtype="float16" (the 16M+ single-chip build knob) must
    not cost build quality: fp16 rounds the stored components once
    (~5e-4 relative) while edge selection still scores in f32, so the
    built graph serves within noise of the f32-descent build."""
    import numpy as np

    from hnsw_tpu import Graph
    from hnsw_tpu.ops.topk import np_exact_topk

    rng = np.random.default_rng(5)
    n, d, k = 3000, 48, 10
    n_c = 30
    centers = rng.standard_normal((n_c, d)).astype(np.float32) * 5
    data = (centers[rng.integers(0, n_c, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, n_c, 64)]
         + 0.3 * rng.standard_normal((64, d)).astype(np.float32))
    gt = np_exact_topk(q, data, k, "cosine")[1]

    def build_and_recall(dtype):
        g = Graph(seed=0)
        g.build(list(range(n)), data, method="device", wave=1024,
                descent_dtype=dtype)
        g.native_serve_max_batch = 0
        keys, _ = g.batch_search(q, k, ef=192)
        return sum(len(set(keys[r]) & set(map(int, gt[r])))
                   for r in range(64)) / (64 * k)

    r32 = build_and_recall("float32")
    r16 = build_and_recall("float16")
    assert r16 >= r32 - 0.03, (r16, r32)


def test_checkpointed_build_resumes_after_crash(tmp_path, monkeypatch):
    """A killed device build restarts from its last wave checkpoint:
    the resumed graph serves every key at quality parity with a
    straight build (long builds must be restartable)."""
    import hnsw_tpu.io.codec as codec

    n, d, ef = 1500, 32, 96
    vecs = make_vectors(n, d, seed=5)
    keys = list(range(n))
    ckpt = str(tmp_path / "build.npz")

    real_save = codec.save_graph
    calls = []

    def crashy_save(g, p, **kw):
        real_save(g, p, **kw)
        calls.append(p)
        if len(calls) == 2:
            raise RuntimeError("simulated crash mid-build")

    monkeypatch.setattr(codec, "save_graph", crashy_save)
    g = Graph(m=8, metric="cosine", seed=0)
    with pytest.raises(RuntimeError, match="simulated crash mid-build"):
        g.build(keys, vecs, method="device", wave=256,
                checkpoint_path=ckpt, checkpoint_every=1)
    monkeypatch.setattr(codec, "save_graph", real_save)

    g2 = Graph.resume_build(ckpt, wave=256)
    assert g2.host.count == n
    assert all((g2.host.levels[g2.slots.key_to_slot[k]] >= 0)
               for k in keys)
    # quality parity with an uninterrupted build
    g_ref = Graph(m=8, metric="cosine", seed=0)
    g_ref.build(keys, vecs, method="device", wave=256)
    q = make_vectors(64, d, seed=99)
    _, gt = np_exact_topk(q, vecs, 10, "cosine")
    for gg, name in ((g2, "resumed"), (g_ref, "straight")):
        kk, _ = gg.batch_search(q, 10, ef=ef)
        rec = np.mean([len(set(kk[r]) & set(map(int, gt[r]))) / 10
                       for r in range(64)])
        if name == "resumed":
            rec_resumed = rec
        else:
            rec_ref = rec
    assert rec_resumed >= rec_ref - 0.05, (rec_resumed, rec_ref)
    # a COMPLETED checkpoint resumes to a no-op load
    g3 = Graph.resume_build(ckpt)
    assert g3.host.count == n


def test_build_abort_deadline_checkpoints_and_resumes(tmp_path):
    """abort_deadline vacates the device gracefully at a wave boundary:
    the build checkpoints, raises BuildDeadlineExceeded, and
    resume_build finishes the remaining waves to a complete graph (a
    long build leaves the device by its deadline with its work saved,
    instead of being killed)."""
    from hnsw_tpu.core.build_device import BuildDeadlineExceeded

    n, d = 1500, 32
    vecs = make_vectors(n, d, seed=7)
    keys = list(range(n))
    ckpt = str(tmp_path / "deadline.npz")

    g = Graph(m=8, metric="cosine", seed=0)
    with pytest.raises(BuildDeadlineExceeded, match="resume_build"):
        g.build(keys, vecs, method="device", wave=256,
                checkpoint_path=ckpt, abort_deadline=0.0)
    # partial: at least the first wave landed, but not the whole set
    inserted = int((g.host.levels >= 0).sum())
    assert 256 <= inserted < n, inserted

    g2 = Graph.resume_build(ckpt, wave=256)
    assert g2.host.count == n
    assert all(g2.host.levels[g2.slots.key_to_slot[kk]] >= 0
               for kk in keys)
    q = make_vectors(32, d, seed=99)
    _, gt = np_exact_topk(q, vecs, 10, "cosine")
    kk, _ = g2.batch_search(q, 10, ef=192)
    rec = np.mean([len(set(kk[r]) & set(map(int, gt[r]))) / 10
                   for r in range(32)])
    assert rec >= 0.85, rec


def test_deadline_abort_serves_inserted_prefix(tmp_path):
    """A deadline-aborted bulk build is SERVABLE, not just resumable:
    the exception carries the partial graph, mask_pending_for_serve
    tombstones the never-inserted tail (slot-assigned, alive=True,
    level<0 — invisible to traversal but not to exact scans), and
    searches over the prefix match a prefix-only oracle. The on-disk
    checkpoint keeps its level<0 markers so resume_build still works."""
    from hnsw_tpu.core.build_device import BuildDeadlineExceeded

    n, d, k = 1500, 32, 10
    vecs = make_vectors(n, d, seed=7)
    ckpt = str(tmp_path / "deadline.npz")

    g = Graph(m=8, metric="cosine", seed=0)
    with pytest.raises(BuildDeadlineExceeded) as ei:
        g.build(list(range(n)), vecs, method="device", wave=256,
                checkpoint_path=ckpt, abort_deadline=0.0)
    gp = ei.value.graph
    assert gp is g
    n_served = gp.mask_pending_for_serve()
    inserted = int((gp.host.levels >= 0).sum())
    assert n_served == inserted and 256 <= n_served < n

    # exact tier over the masked store == prefix-only oracle
    q = make_vectors(32, d, seed=99)
    _, gt = np_exact_topk(q, vecs[:n_served], k, "cosine")
    kk, _ = gp.batch_search(q, k, ef=192)
    rec = np.mean([len(set(kk[r]) & set(map(int, gt[r]))) / k
                   for r in range(32)])
    assert rec >= 0.85, rec
    served = {int(key) for row in kk for key in row}
    assert max(served) < n_served, "served a never-inserted slot"

    # the checkpoint is still a resumable PARTIAL (masking was in-mem)
    g2 = Graph.resume_build(ckpt, wave=256)
    assert g2.host.count == n


@pytest.mark.skipif(not __import__("os").environ.get("HNSW_TPU_SLOW"),
                    reason="slow seq-vs-wave anchor; set HNSW_TPU_SLOW=1")
def test_seq_vs_wave_anchor_midscale():
    """Mid-scale slice of the external quality anchor (BASELINE.md): the
    wave builder must not be WORSE than reference-faithful sequential
    insertion (graph.go:514-599) at any ef rung. One-sided by design —
    at 100k+ the wave builder measures slightly BETTER."""
    n, d, k = 8000, 64, 10
    v = make_vectors(n, d, seed=70)
    q = make_vectors(64, d, seed=71)
    _, gt = np_exact_topk(q, v, k, "cosine")

    g_seq = Graph(seed=0)
    g_seq.build(list(range(n)), v, method="host")     # sequential insertion
    g_wave = Graph(seed=0)
    g_wave.build(list(range(n)), v, method="device", wave=1024)

    for ef in (96, 192, 384):
        r_seq = _recall(g_seq.batch_search(q, k, ef=ef)[0], gt, k)
        r_wave = _recall(g_wave.batch_search(q, k, ef=ef)[0], gt, k)
        assert r_wave >= r_seq - 0.02, (ef, r_seq, r_wave)


def test_host_build_checkpoint_deadline_and_resume(tmp_path):
    """Native (host) builds honor checkpoint_path + abort_deadline
    with the same slice semantics as device waves (auto routes host up
    to 500k now, so multi-minute native builds must be restartable),
    and resume_build(method='host') finishes the pending tail."""
    from hnsw_tpu.core.build_device import BuildDeadlineExceeded

    n, d = 1200, 24
    vecs = make_vectors(n, d, seed=6)
    keys = list(range(n))
    ckpt = str(tmp_path / "hostbuild.npz")

    g = Graph(m=8, metric="cosine", seed=0)
    # deadline already past: first slice inserts, checkpoints, raises
    with pytest.raises(BuildDeadlineExceeded, match="resume"):
        g.build(keys, vecs, method="host", wave=128,
                checkpoint_path=ckpt, checkpoint_every=2,
                abort_deadline=0.0)

    g2 = Graph.resume_build(ckpt, wave=128, method="host")
    assert g2.host.count == n
    assert all((g2.host.levels[g2.slots.key_to_slot[k]] >= 0)
               for k in keys)
    q = make_vectors(48, d, seed=98)
    _, gt = np_exact_topk(q, vecs, 10, "cosine")
    kk, _ = g2.batch_search(q, 10, ef=128)
    rec = np.mean([len(set(kk[r]) & set(map(int, gt[r]))) / 10
                   for r in range(48)])
    assert rec >= 0.9, rec
    # a finished checkpoint just loads
    g3 = Graph.resume_build(ckpt, method="auto")
    assert g3.host.count == n
