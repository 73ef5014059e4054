"""Multi-device tests on the virtual 8-device CPU mesh (conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_tpu import Graph
from hnsw_tpu.ops.topk import np_exact_topk
from hnsw_tpu.parallel.sharded import (default_mesh, partitioned_graph_search,
                                       sharded_exact_topk,
                                       sharded_graph_search)


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_exact_matches_oracle():
    n, d, k = 512, 16, 7
    rng = np.random.default_rng(30)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((9, d)).astype(np.float32)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    mesh = default_mesh()
    dk, ik = sharded_exact_topk(jnp.asarray(q), jnp.asarray(v),
                                jnp.asarray(sq),
                                jnp.ones(n, bool), k=k, metric="l2",
                                mesh=mesh)
    gt_d, gt_i = np_exact_topk(q, v, k, "l2")
    np.testing.assert_array_equal(np.asarray(ik), gt_i)
    np.testing.assert_allclose(np.asarray(dk), gt_d, rtol=1e-4, atol=1e-4)


def test_sharded_graph_search_matches_single_device():
    rng = np.random.default_rng(31)
    v = rng.standard_normal((300, 16)).astype(np.float32)
    g = Graph(seed=0)
    g.batch_add(list(range(300)), v)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    # single-device result
    keys1, d1 = g.batch_search(q, 5, ef=40)
    # sharded over 8 virtual devices
    mesh = default_mesh()
    dev = g.device_graph()
    d2, i2 = sharded_graph_search(dev, jnp.asarray(q), k=5, ef=40,
                                  metric="cosine", mesh=mesh)
    keys2 = [g.slots.keys_for(np.asarray(row)) for row in np.asarray(i2)]
    assert keys1 == keys2
    np.testing.assert_allclose(d1, np.asarray(d2), rtol=1e-4, atol=1e-5)


def test_partitioned_graph_search_recall():
    # 8 independent sub-graphs (one per device) over a partitioned
    # dataset; merged top-k should approximate global exact search.
    rng = np.random.default_rng(32)
    n_per, d, k = 100, 16, 5
    parts = [rng.standard_normal((n_per, d)).astype(np.float32)
             for _ in range(8)]
    graphs = []
    for p in parts:
        gg = Graph(seed=0, ef_construction=60)
        gg.batch_add(list(range(n_per)), p)
        graphs.append(gg.device_graph())
    # stack to leading device axis; pad caps to the max
    cap = max(g.cap for g in graphs)
    L = max(g.num_layers for g in graphs)

    def pad(g):
        import jax.numpy as jnp
        pc = cap - g.cap
        pl = L - g.num_layers
        return type(g)(
            vectors=jnp.pad(g.vectors, ((0, pc), (0, 0))),
            sq_norms=jnp.pad(g.sq_norms, (0, pc)),
            neighbors=jnp.pad(g.neighbors, ((0, pl), (0, pc), (0, 0)),
                              constant_values=-1),
            levels=jnp.pad(g.levels, (0, pc), constant_values=-1),
            alive=jnp.pad(g.alive, (0, pc)),
            entry=g.entry,
        )

    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[pad(g) for g in graphs])
    q = rng.standard_normal((6, d)).astype(np.float32)
    mesh = default_mesh()
    dk, ik = partitioned_graph_search(stacked, jnp.asarray(q), k=k, ef=60,
                                      metric="cosine", mesh=mesh)
    allv = np.concatenate(parts)
    gt_d, gt_i = np_exact_topk(q, allv, k, "cosine")
    ik = np.asarray(ik)
    # decode (partition, slot) -> global row
    globals_ = []
    for row in ik:
        dec = []
        for x in row:
            p, s = divmod(int(x), cap)
            dec.append(p * n_per + s)
        globals_.append(dec)
    hits = sum(len(set(globals_[i]) & set(map(int, gt_i[i])))
               for i in range(len(gt_i)))
    assert hits / (len(gt_i) * k) >= 0.8


def test_partitioned_graph_class_end_to_end():
    import numpy as np
    from hnsw_tpu.parallel.partitioned import PartitionedGraph
    from hnsw_tpu.ops.topk import np_exact_topk
    from tests.conftest import make_vectors

    v = make_vectors(800, 16, seed=120, kind="clustered")
    pg = PartitionedGraph()
    pg.build([f"k{i}" for i in range(800)], v, wave=128)
    assert len(pg) == 800
    s = pg.stats()
    assert sum(s["sizes"]) == 800
    q = make_vectors(12, 16, seed=121, kind="clustered")
    keys, dists = pg.batch_search(q, 5, ef=60)
    _, gt = np_exact_topk(q, v, 5, "cosine")
    hits = sum(len({int(k[1:]) for k in keys[i] if k is not None} &
                   set(map(int, gt[i]))) for i in range(12))
    assert hits / 60 >= 0.85
    # single + mutation
    res = pg.search(v[3], 1)
    assert res[0][0] == "k3"
    assert pg.delete("k3")
    assert pg.search(v[3], 1)[0][0] != "k3"
    pg.add("new", v[3])
    assert pg.search(v[3], 1)[0][0] == "new"


def test_multihost_shards_route_and_merge():
    """Multi-host scale-out: independent slices + host merge (the reference's
    unimplemented distributed sketch, hnsw-extensions.md:233-271)."""
    import numpy as np
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.ops.topk import np_exact_topk
    from hnsw_tpu.parallel.multihost import (LocalTransport,
                                             MultiHostIndex)
    from tests.conftest import make_vectors

    n, d, k = 600, 16, 5
    v = make_vectors(n, d, seed=130)
    q = make_vectors(20, d, seed=131)
    slices = [ExactIndex(metric="cosine") for _ in range(4)]
    mh = MultiHostIndex(LocalTransport(slices))
    mh.batch_add(list(range(n)), v)
    assert len(mh) == n
    # every slice got a nontrivial share
    st = mh.stats()
    assert all(c > 0 for c in st["per_slice"])
    keys, dists = mh.batch_search(q, k)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    for i in range(len(q)):
        assert keys[i] == [int(x) for x in gt_i[i]]
    # delete routes to the owning slice
    assert mh.delete(5)
    assert not mh.delete(5)
    assert len(mh) == n - 1
    assert mh.search(v[5], 1)[0][0] != 5


def test_multihost_replicas_survive_slice_loss():
    import numpy as np
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.parallel.multihost import (LocalTransport,
                                             MultiHostIndex)
    from tests.conftest import make_vectors

    n, d = 200, 8
    v = make_vectors(n, d, seed=132)
    slices = [ExactIndex(metric="cosine") for _ in range(3)]
    mh = MultiHostIndex(LocalTransport(slices), replicas=2)
    mh.batch_add(list(range(n)), v)
    assert len(mh) == n
    # kill one slice: every key still served by its replica
    dead = 1
    slices[dead].batch_delete(slices[dead].keys())
    keys, _ = mh.batch_search(v[:32], 1)
    assert [r[0] for r in keys] == list(range(32))


def test_multihost_over_tcp_sockets():
    """Cross-process transport: slices behind real TCP servers
    (parallel/rpc.SliceServer + SocketTransport) — the concrete form of
    the reference's gRPC-transport sketch. No pickle on the wire."""
    import numpy as np
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.ops.topk import np_exact_topk
    from hnsw_tpu.parallel.multihost import MultiHostIndex
    from hnsw_tpu.parallel.rpc import SliceServer, SocketTransport
    from tests.conftest import make_vectors

    n, d, k = 400, 16, 5
    v = make_vectors(n, d, seed=132)
    q = make_vectors(10, d, seed=133)
    servers = [SliceServer(ExactIndex(metric="cosine"))
               for _ in range(3)]
    addrs = [s.start() for s in servers]
    tr = SocketTransport(addrs)
    try:
        mh = MultiHostIndex(tr, replicas=2)
        # tuple + int keys round-trip the wire codec
        keys_in = [("doc", i) if i % 2 else i for i in range(n)]
        mh.batch_add(keys_in, v)
        st = mh.stats()
        assert all(c > 0 for c in st["per_slice"])
        keys, dists = mh.batch_search(q, k)
        gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
        for i in range(len(q)):
            assert keys[i] == [keys_in[int(x)] for x in gt_i[i]]
            np.testing.assert_allclose(dists[i], gt_d[i], atol=1e-5)
        assert mh.delete(keys_in[7])
        assert mh.search(v[7], 1)[0][0] != keys_in[7]
        # disallowed method is refused, connection keeps serving
        import pytest
        with pytest.raises(RuntimeError, match="not allowed"):
            tr.call(0, "device_graph")
        assert tr.call(0, "__len__") > 0
    finally:
        tr.close()
        for s in servers:
            s.shutdown()

def test_multihost_tcp_dead_slice_failover_and_reconnect():
    """Transport hardening: (a) with replicas, search keeps serving when
    a slice SERVER dies (read failover — the reference sketch's replica
    promise); (b) a RESTARTED server on the same port is transparently
    reconnected; (c) with replicas=1 a dead slice raises instead of
    silently dropping keys."""
    import warnings

    import numpy as np
    import pytest
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.parallel.multihost import MultiHostIndex
    from hnsw_tpu.parallel.rpc import SliceServer, SocketTransport
    from tests.conftest import make_vectors

    n, d = 200, 8
    v = make_vectors(n, d, seed=134)
    idxs = [ExactIndex(metric="cosine") for _ in range(3)]
    servers = [SliceServer(ix) for ix in idxs]
    addrs = [s.start() for s in servers]
    tr = SocketTransport(addrs, timeout=5.0, retry_backoff=0.05)
    try:
        mh = MultiHostIndex(tr, replicas=2)
        mh.batch_add(list(range(n)), v)

        # (b) restart slice 0's server on the SAME port: the stale
        # connection breaks mid-call and the transport reconnects.
        assert tr.call(0, "__len__") > 0          # open the connection
        servers[0].shutdown()
        servers[0] = SliceServer(idxs[0], host=addrs[0][0],
                                 port=addrs[0][1])
        servers[0].start()
        assert tr.call(0, "__len__") > 0          # replayed transparently

        # (a) kill slice 1 for good: replicas still cover every key
        servers[1].shutdown()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            keys, _ = mh.batch_search(v[:32], 1)
        assert [r[0] for r in keys] == list(range(32))

        # (c) no replicas -> a dead slice is an error, not silent loss
        mh1 = MultiHostIndex(tr, replicas=1)
        with pytest.raises(Exception):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                mh1.batch_search(v[:4], 1)
    finally:
        tr.close()
        for s in servers:
            try:
                s.shutdown()
            except Exception:
                pass

def test_multihost_raises_when_failures_reach_replica_count():
    """Read fan-out tolerates up to replicas-1 dead slices; at replicas
    dead slices some key's whole owner set may be gone, so batch_search
    raises instead of silently returning partial results."""
    import warnings

    import numpy as np
    import pytest
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.parallel.multihost import (LocalTransport,
                                             MultiHostIndex)
    from tests.conftest import make_vectors

    n, d = 120, 8
    v = make_vectors(n, d, seed=140)

    class FlakyTransport(LocalTransport):
        def __init__(self, indexes):
            super().__init__(indexes)
            self.dead = set()

        def call(self, slice_id, method, *args, **kw):
            if slice_id in self.dead:
                raise ConnectionError(f"slice {slice_id} down")
            return super().call(slice_id, method, *args, **kw)

    slices = [ExactIndex(metric="cosine") for _ in range(4)]
    tr = FlakyTransport(slices)
    mh = MultiHostIndex(tr, replicas=2)
    mh.batch_add(list(range(n)), v)

    tr.dead = {1}          # one dead < replicas: still serves
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        keys, _ = mh.batch_search(v[:8], 1)
    assert [r[0] for r in keys] == list(range(8))

    tr.dead = {1, 2}       # dead slices == replicas: must raise
    with pytest.raises(ConnectionError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            mh.batch_search(v[:8], 1)


def test_sharded_quantized_candidates_int8_and_bf16():
    """Row-sharded capacity-mode scan: per-shard reduced-precision
    candidates + global merge must contain the true top-k (the host
    rerank then restores exact ordering, as in the single-chip mode)."""
    import ml_dtypes
    from hnsw_tpu.parallel.sharded import sharded_quantized_candidates

    n, d, k, kk = 4096, 32, 10, 26
    rng = np.random.default_rng(60)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((32, d)).astype(np.float32)
    sq = np.sum(v.astype(np.float64) * v, axis=1).astype(np.float32)
    _, gt = np_exact_topk(q, v, k, "cosine")
    mesh = default_mesh()
    alive = jnp.ones((n,), bool)

    # int8 shards with per-row scales
    amax = np.max(np.abs(v), axis=1)
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    v8 = np.clip(np.rint(v / s[:, None]), -127, 127).astype(np.int8)
    dq, iq = sharded_quantized_candidates(
        jnp.asarray(q), jnp.asarray(v8), jnp.asarray(s),
        jnp.asarray(sq), alive, kk=kk, metric="cosine", mesh=mesh)
    iq = np.asarray(iq)
    rec = np.mean([len(set(iq[r]) & set(gt[r])) / k for r in range(32)])
    assert rec >= 0.95, f"int8 containment {rec}"

    # bf16 shards (scales=None path)
    db, ib = sharded_quantized_candidates(
        jnp.asarray(q), jnp.asarray(v.astype(ml_dtypes.bfloat16)), None,
        jnp.asarray(sq), alive, kk=k + 4, metric="cosine", mesh=mesh)
    ib = np.asarray(ib)
    rec = np.mean([len(set(ib[r]) & set(gt[r])) / k for r in range(32)])
    assert rec >= 0.99, f"bf16 containment {rec}"

    # fp16 shards (scales=None; ops/topk dtype branch keeps queries f32)
    df, if_ = sharded_quantized_candidates(
        jnp.asarray(q), jnp.asarray(v.astype(np.float16)), None,
        jnp.asarray(sq), alive, kk=k + 4, metric="cosine", mesh=mesh)
    if_ = np.asarray(if_)
    rec = np.mean([len(set(if_[r]) & set(gt[r])) / k for r in range(32)])
    assert rec >= 0.99, f"fp16 containment {rec}"
    # global ids: every id in range, none from padded space
    assert int(ib.max()) < n and int(iq.max()) < n and int(if_.max()) < n


def test_multihost_over_capacity_mode_slices():
    """Capacity-mode ExactIndex slices compose under MultiHostIndex
    unchanged (SearchableIndex protocol): consistent-hash routing +
    host merge over int8-HBM slices, ~33M rows/chip each — a
    multi-HOST capacity fabric with no new code."""
    from hnsw_tpu.index.exact import ExactIndex
    from hnsw_tpu.parallel.multihost import LocalTransport, MultiHostIndex

    rng = np.random.default_rng(77)
    n, d, k = 3000, 32, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    slices = [ExactIndex(metric="cosine", hbm_dtype="int8")
              for _ in range(4)]
    for s in slices:
        s.host_serve_max_batch = 0
    mh = MultiHostIndex(LocalTransport(slices))
    mh.batch_add(list(range(n)), v)
    q = rng.standard_normal((16, d)).astype(np.float32)
    keys, dists = mh.batch_search(q, k)
    _, gt = np_exact_topk(q, v, k, "cosine")
    rec = np.mean([len({kk for kk in keys[r] if kk is not None}
                       & set(gt[r])) / k for r in range(16)])
    assert rec >= 0.95, f"multihost capacity recall {rec}"
    # self-NN routes through the right slice and survives quantization
    keys2, d2 = mh.batch_search(v[:8], 1)
    assert [row[0] for row in keys2] == list(range(8))


def test_sharded_ivf_candidates_matches_single_device():
    """Block-sharded IVF (parallel/sharded.sharded_ivf_candidates):
    shard the IVFIndex's own [NB, bs, D] block table over the mesh and
    assert the merged probed scan matches the single-device IVF result
    at the same nprobe, and hits the exact oracle at nprobe=P."""
    from hnsw_tpu.index.ivf import IVFIndex
    from hnsw_tpu.parallel.sharded import sharded_ivf_candidates

    rng = np.random.default_rng(33)
    n, d, k, P = 800, 24, 6, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((12, d)).astype(np.float32)

    ivf = IVFIndex(num_partitions=P, nprobe=P, metric="cosine", seed=0)
    ivf.build(list(range(n)), v)
    blocks, block_sq, block_valid, block_slot, cents, part_blocks = \
        ivf._sync()

    # block -> owning partition, padded to a multiple of the mesh size
    NB = blocks.shape[0]
    mesh = default_mesh()
    S = mesh.shape["data"]
    nb_pad = -(-NB // S) * S
    block_part = np.full(nb_pad, -1, np.int32)
    for p, bl in enumerate(part_blocks):
        for b in bl:
            block_part[b] = p
    pad = nb_pad - NB
    bs = blocks.shape[1]
    blocks_p = jnp.pad(blocks, ((0, pad), (0, 0), (0, 0)))
    bsq_p = jnp.pad(block_sq, ((0, pad), (0, 0)))
    bv_p = jnp.pad(block_valid, ((0, pad), (0, 0)))

    dk, ik = sharded_ivf_candidates(
        jnp.asarray(q), cents, blocks_p, bsq_p, bv_p,
        jnp.asarray(block_part), nprobe=P, k=k, metric="cosine",
        mesh=mesh)
    ik = np.asarray(ik)
    # decode flattened [NB*bs] grid ids -> store slots
    flat_slot = np.pad(block_slot, ((0, pad), (0, 0)),
                       constant_values=-1).reshape(-1)
    slots = np.where(ik >= 0, flat_slot[np.clip(ik, 0, None)], -1)

    # nprobe=P probes everything: must equal the exact oracle
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    np.testing.assert_array_equal(slots, gt_i)
    np.testing.assert_allclose(np.asarray(dk), gt_d, rtol=1e-4, atol=1e-4)

    # a partial probe matches the single-device IVF at the same nprobe
    keys1, _ = ivf.batch_search(q, k, _nprobe=4)
    dk2, ik2 = sharded_ivf_candidates(
        jnp.asarray(q), cents, blocks_p, bsq_p, bv_p,
        jnp.asarray(block_part), nprobe=4, k=k, metric="cosine",
        mesh=mesh)
    ik2 = np.asarray(ik2)
    slots2 = np.where(ik2 >= 0, flat_slot[np.clip(ik2, 0, None)], -1)
    keys2 = [[ivf.slots.keys_for(np.asarray([s]))[0] if s >= 0 else None
              for s in row] for row in slots2]
    assert keys1 == keys2


def test_rowsharded_single_graph_recall_and_parity():
    """M6: ONE graph with layer-0 rows sharded over the mesh must match
    the single-device pivot-seeded search on the same graph (the
    distances are owner-computed at HIGHEST and psum'd exactly once)
    and clear the oracle recall bar."""
    from hnsw_tpu.core.search import pivot_seeds, search_graph
    from hnsw_tpu.parallel.rowsharded import (make_row_shards,
                                              rowsharded_graph_search)

    rng = np.random.default_rng(33)
    n, d, k, ef, nq = 4096, 64, 10, 128, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    g = Graph(m=8, seed=0, ef_construction=60)
    g.build(list(range(n)), v, wave=512)

    mesh = default_mesh()
    shards = make_row_shards(g, 8)
    assert shards.nbr0.shape[0] % 8 == 0
    dk, ik = rowsharded_graph_search(shards, jnp.asarray(q), k=k, ef=ef,
                                     seeds=16, expand=2, mesh=mesh)
    ik = np.asarray(ik)

    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    rec = sum(len(set(map(int, ik[r])) & set(map(int, gt_i[r])))
              for r in range(nq)) / (nq * k)
    assert rec >= 0.85, f"row-sharded recall {rec:.3f}"

    # parity vs the single-device pivot-seeded beam (same entry mode,
    # same merge network, same expand)
    g.entry_mode = "pivots"
    dev = g.device_graph()
    pids, pvecs, psq = g._pivot_arrays()
    seeds = pivot_seeds(jnp.asarray(q), pvecs, psq, pids, s=16,
                        metric="cosine")
    d1, i1 = search_graph(dev, jnp.asarray(q), k=k, ef=ef,
                          metric="cosine", expand=2, seed_ids=seeds,
                          merge="bitonic")
    i1 = np.asarray(i1)
    overlap = sum(len(set(map(int, ik[r])) & set(map(int, i1[r])))
                  for r in range(nq)) / (nq * k)
    assert overlap >= 0.9, f"single-device parity overlap {overlap:.3f}"


def test_rowsharded_fp16_capacity_rows():
    """fp16 shard rows (the >HBM capacity mode) serve the same results
    on well-separated data."""
    from hnsw_tpu.parallel.rowsharded import (make_row_shards,
                                              rowsharded_graph_search)

    rng = np.random.default_rng(34)
    n, d, k = 2048, 32, 5
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    g = Graph(m=8, seed=0)
    g.build(list(range(n)), v, wave=512)
    mesh = default_mesh()
    s32 = make_row_shards(g, 8)
    s16 = make_row_shards(g, 8, dtype="float16")
    assert str(s16.vectors.dtype) == "float16"
    _, i32 = rowsharded_graph_search(s32, jnp.asarray(q), k=k, ef=64,
                                     mesh=mesh)
    _, i16 = rowsharded_graph_search(s16, jnp.asarray(q), k=k, ef=64,
                                     mesh=mesh)
    i32, i16 = np.asarray(i32), np.asarray(i16)
    overlap = sum(len(set(map(int, i32[r])) & set(map(int, i16[r])))
                  for r in range(len(i32))) / i32.size
    assert overlap >= 0.9, f"fp16 rows overlap {overlap:.3f}"


def test_rowsharded_prefolds_deleted_nodes():
    """make_row_shards must fold edges to tombstoned nodes to -1 (the
    state.from_host prefold contract): deleted keys never surface."""
    from hnsw_tpu.parallel.rowsharded import (make_row_shards,
                                              rowsharded_graph_search)

    rng = np.random.default_rng(35)
    n, d, k = 1024, 32, 5
    v = rng.standard_normal((n, d)).astype(np.float32)
    g = Graph(m=8, seed=0)
    g.build(list(range(n)), v, wave=512)
    dead = list(range(0, n, 7))
    g.batch_delete(dead)
    shards = make_row_shards(g, 8)
    q = v[1:9] + 0.01 * rng.standard_normal((8, d)).astype(np.float32)
    _, ik = rowsharded_graph_search(shards, jnp.asarray(q), k=k, ef=64,
                                    mesh=default_mesh())
    ik = np.asarray(ik)
    dead_set = set(dead)
    assert not any(int(s) in dead_set for row in ik for s in row if s >= 0)
