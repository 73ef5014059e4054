"""Device-resident graph state.

THE central design decision of the rebuild (SURVEY.md §7.1): the three
pointer-graph HNSW implementations of the reference (graph.go,
parquet/graph.go, arrow/graph.go) collapse into ONE fixed-shape array
representation that lives in HBM:

    vectors   f32[cap, D]      raw vectors (row = dense slot id)
    sq_norms  f32[cap]         cached squared norms (distance epilogues)
    neighbors i32[L, cap, M]   per-layer fixed-degree adjacency, -1 = empty
    levels    i32[cap]         node's max layer, -1 = free slot
    alive     bool[cap]        tombstones (batch delete = mask flip)
    entry     i32 scalar       entry slot (a node on the top layer)

Keys never reach the device (utils/keystore.SlotMap holds them). All
shapes are static under jit; growth re-buckets cap (doubling) and L,
which triggers a recompile — rare by design (log-many times over an
index's life).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hnsw_tpu.utils.transfer import chunked_put


class DeviceGraph(NamedTuple):
    vectors: jnp.ndarray   # [cap, D] float32 (or bfloat16 store)
    sq_norms: jnp.ndarray  # [cap] float32
    neighbors: jnp.ndarray  # [L, cap, M] int32, -1 padded
    levels: jnp.ndarray    # [cap] int32, -1 = unused
    alive: jnp.ndarray     # [cap] bool
    entry: jnp.ndarray     # [] int32
    #: optional int8 traversal store: hop scoring gathers these (4x fewer
    #: HBM bytes than f32); the final pool is reranked against
    #: ``vectors`` in f32. qscale is the per-row dequant factor
    #: (absmax/127), folded into the Gram epilogue, not the gather.
    qvec: Optional[jnp.ndarray] = None     # [cap, D] int8
    qscale: Optional[jnp.ndarray] = None   # [cap] float32
    #: optional contiguous neighbor-vector blocks for layer 0: hop
    #: scoring gathers ONE [M0, D] int8 block per expanded node instead
    #: of M0 separate vector rows. XLA gathers are row-granularity-bound
    #: (hop_micro3: ~50 GB/s effective on 512 B rows), so 4 KB blocks
    #: reach streaming bandwidth. Costs M0 x D bytes/node of HBM —
    #: the classic DiskANN-style speed/space trade. block_scale is the
    #: GLOBAL dequant factor (blocks and qvec share it in this mode).
    nbr_blocks: Optional[jnp.ndarray] = None   # [cap, M0, D] int8
    block_scale: Optional[jnp.ndarray] = None  # [] float32
    #: optional SPLIT upper-layer storage: when set, ``neighbors`` holds
    #: ONLY layer 0 ([1, cap, M0]) and this holds layers 1..L-1 at the
    #: upper degree m. Two layouts:
    #:   * dense array [L-1, cap, m] — rows indexed by slot id;
    #:   * COMPACT jagged tuple of [U_l, m] arrays (one per upper
    #:     layer), rows indexed by ``upper_map[slot]``. Upper ids are
    #:     assigned by DESCENDING node level, so the nodes of layer l
    #:     (an ml^l fraction) occupy a PREFIX of every table and each
    #:     layer allocates only its own occupancy: ~0.2 GB total at 8M
    #:     vs 5.9 GB dense — the 8M+ single-chip enabler (the dense
    #:     [L, cap, max(m0, m)] stack before it was the 4M blocker).
    nbr_upper: "Optional[jnp.ndarray | tuple]" = None
    #: slot -> compact upper row (int32 [cap], -1 = node has no upper
    #: layers). Set IFF nbr_upper is the compact jagged tuple.
    upper_map: Optional[jnp.ndarray] = None

    @property
    def cap(self) -> int:
        # from neighbors, not vectors: in the HBM-quantized capacity
        # mode ``vectors`` is a [1, D] placeholder (qvec serves hops,
        # the host reranks against the disk store)
        return self.neighbors.shape[1]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_layers(self) -> int:
        if self.nbr_upper is not None:
            return self.neighbors.shape[0] + len(self.nbr_upper)
        return self.neighbors.shape[0]

    @property
    def m(self) -> int:
        return self.neighbors.shape[2]

    def layer_neighbors(self, layer: int) -> jnp.ndarray:
        """[cap, width] adjacency of one layer (width is M0 for layer 0
        and m for uppers when the split storage is active). Not defined
        for compact-upper graphs above layer 0 — use gather_neighbors."""
        if self.nbr_upper is not None and layer > 0:
            if self.upper_map is not None:
                raise ValueError(
                    "compact upper storage has no [cap, m] table; "
                    "gather rows via gather_neighbors()")
            return self.nbr_upper[layer - 1]
        return self.neighbors[layer]

    def layer_width(self, layer: int) -> int:
        """Edge width of one layer's rows (static)."""
        if self.nbr_upper is not None and layer > 0:
            return self.nbr_upper[layer - 1].shape[-1]
        return self.neighbors.shape[2]

    def gather_neighbors(self, layer: int, ids: jnp.ndarray) -> jnp.ndarray:
        """Neighbor rows of ``ids`` (any shape of IN-RANGE slot ids) at
        one layer -> [..., width] int32, -1 padded. The single adjacency
        read used by the beam search — it hides which upper layout
        (dense by slot / compact by upper_map rank) is active."""
        if self.nbr_upper is not None and layer > 0:
            tab = self.nbr_upper[layer - 1]
            if self.upper_map is not None:
                u = self.upper_map[ids]
                rows = tab[jnp.clip(u, 0, tab.shape[0] - 1)]
                return jnp.where((u >= 0)[..., None], rows, -1)
            return tab[ids]
        return self.neighbors[layer][ids]


def bucket_pow2(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def quantize_rows(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization.

    Returns (q int8[N, D], scale f32[N]) with scale = absmax/127 so that
    ``q * scale`` reconstructs the row. Zero rows get scale 0.
    """
    v = np.asarray(vectors, np.float32)
    absmax = np.max(np.abs(v), axis=-1)
    scale = absmax / 127.0
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    q = np.clip(np.rint(v * inv[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _int8_block_fit(vectors: np.ndarray, metric: str = "cosine",
                    probes: int = 32, k: int = 10,
                    max_rows: int | None = None) -> float:
    """How well global-int8 scoring preserves neighbor RANKING.

    Returns mean top-k overlap between f32-cosine and int8-dequant
    neighbor sets for sampled probes scanned against the FULL store
    (chunked; capped at ``max_rows``). Near 1.0 on spread-out data;
    collapses on tightly clustered data, where within-cluster
    separations (~1e-3 cosine) drown in int8 quantization noise: 1M
    clustered rows served at recall 0.33 with int8 blocks vs 0.99
    without.

    The scan must run at FULL density: subsampling the store inflates
    the k-NN gaps and the check false-passes — a 131k subsample of 1M
    clustered scored 0.95 while full-density scored far lower and
    serving collapsed. ``max_rows`` therefore defaults to None (scan
    everything, 4M+ included); pass a cap only when a caller knowingly
    accepts the false-pass risk. Cost: 2 host matmuls of
    [probes, N, D] in chunks.

    ``metric`` must match the serving metric, and the check quantizes
    what PRODUCTION quantizes: for cosine the store is prenormalized
    before int8 conversion (from_host/device_graph), so the fit is
    measured on normalized rows — raw rows with wildly varying norms
    would mis-measure both ways."""
    n = vectors.shape[0]
    if n < 4 * k:
        return 1.0
    rng = np.random.default_rng(0)
    if max_rows is not None and n > max_rows:
        rows = np.sort(rng.choice(n, max_rows, replace=False))
        vs_src = vectors[rows]
        n = max_rows
    else:
        vs_src = vectors

    def prep(vm):
        vm = np.asarray(vm, np.float32)
        if metric == "cosine":
            return vm / np.maximum(
                np.linalg.norm(vm, axis=1, keepdims=True), 1e-30)
        return vm

    q_idx = rng.choice(n, min(probes, n), replace=False)
    q = prep(vs_src[q_idx])
    q_sq = np.sum(q * q, axis=1)
    # global absmax over the PREPPED rows, strided sample
    gs = 0.0
    for c0 in range(0, n, 65536):
        gs = max(gs, float(np.abs(prep(vs_src[c0:c0 + 4096])).max()))
    gs = (gs / 127.0) or 1.0

    def dists(qm, qsq, mat):
        qv = qm @ mat.T
        if metric == "dot":
            return -qv
        if metric == "cosine":
            nr = np.maximum(np.linalg.norm(mat, axis=1), 1e-30)
            return 1.0 - qv / nr[None, :]
        vsq = np.sum(mat * mat, axis=1)
        return qsq[:, None] + vsq[None, :] - 2.0 * qv   # (sq)euclidean

    kk = min(k + 1, n)
    P = len(q)
    d32 = np.full((P, kk), np.inf, np.float32)
    i32 = np.full((P, kk), -1, np.int64)
    d8 = np.full((P, kk), np.inf, np.float32)
    i8 = np.full((P, kk), -1, np.int64)
    for c0 in range(0, n, 131072):
        c1 = min(c0 + 131072, n)
        vm = prep(vs_src[c0:c1])
        v8 = np.clip(np.rint(vm / gs), -127, 127) * gs
        for dbuf, ibuf, mat in ((d32, i32, vm), (d8, i8, v8)):
            d = dists(q, q_sq, mat)
            cat_d = np.concatenate([dbuf, d], axis=1)
            cat_i = np.concatenate(
                [ibuf, np.broadcast_to(np.arange(c0, c1), (P, c1 - c0))],
                axis=1)
            part = np.argpartition(cat_d, kk - 1, axis=1)[:, :kk]
            dbuf[:] = np.take_along_axis(cat_d, part, axis=1)
            ibuf[:] = np.take_along_axis(cat_i, part, axis=1)
    return float(np.mean([len(set(i32[i]) & set(i8[i])) / kk
                          for i in range(P)]))


def from_host(vectors: np.ndarray, sq_norms: np.ndarray,
              neighbors: np.ndarray, levels: np.ndarray,
              alive: np.ndarray, entry: int,
              cap_pad: int | None = None,
              store_dtype=np.float32,
              quantize: bool = False,
              hbm_vectors: bool = True,
              block_layout: bool = False,
              block_m: int | None = None,
              block_dtype: str = "auto",
              metric: str = "cosine",
              split_layers: "bool | str" = False,
              upper_m: int | None = None) -> DeviceGraph:
    """Upload padded host arrays to device, bucketing capacity.

    ``hbm_vectors=False`` (requires quantize=True) uploads only the int8
    store + a [1, D] f32 placeholder — the capacity mode where raw
    vectors stay on disk/host and searches rerank off-device.

    ``block_layout`` additionally materializes layer-0 neighbor-vector
    blocks, built by ONE device gather from an uploaded store — never
    shipped row-by-row from the host.

    ``block_dtype``: "int8" (global scale, 1 byte/component — the fast
    default for spread-out data), "float16" (2 bytes — needed when
    within-cluster separations drown in int8 noise), or "auto"
    (sample-check int8's ranking fidelity via _int8_block_fit and pick).
    ``metric`` is the SERVING metric — it parameterizes the auto fit
    check (a cosine-based fidelity decision is wrong for l2/dot data).
    """
    if not hbm_vectors and not (quantize or block_layout):
        raise ValueError("hbm_vectors=False requires quantize=True")
    if block_layout:
        quantize = True
    n = vectors.shape[0]
    cap = cap_pad if cap_pad is not None else bucket_pow2(n)
    # bit 30 of slot ids carries the search pool's "expanded" flag
    # (core/search._EXP_BIT); ids at/above 2^30 would be corrupted.
    if cap >= (1 << 30):
        raise ValueError(
            f"cap {cap} >= 2^30: slot ids would collide with the "
            "search pool's expanded-flag bit (core/search._EXP_BIT)")
    L, _, m = neighbors.shape

    def pad_rows(a, fill):
        if a.shape[-2 if a.ndim == 3 else 0] == cap:
            return a
        if a.ndim == 3:
            out = np.full((L, cap, m), fill, a.dtype)
            out[:, :n] = a
        elif a.ndim == 2:
            out = np.zeros((cap, a.shape[1]), a.dtype)
            out[:n] = a
        else:
            out = np.full((cap,), fill, a.dtype)
            out[:n] = a
        return out

    # Prefold tombstones into the adjacency: edges to dead nodes become
    # -1 here, so the search hop never gathers an alive mask
    # (core/search.beam_search_layer relies on this invariant).
    nb = np.asarray(neighbors, np.int32)
    al = np.asarray(alive, bool)
    if nb.size and not al.all():
        safe = np.clip(nb, 0, al.shape[0] - 1)
        nb = np.where((nb >= 0) & al[safe], nb, -1)

    qvec = qscale = None
    gscale = None
    if quantize and vectors.size:
        if block_layout:
            # global scale: blocks and rows dequantize with one scalar
            gscale = float(np.abs(vectors).max()) / 127.0 or 1.0
            q = np.clip(np.rint(vectors.astype(np.float32) / gscale),
                        -127, 127).astype(np.int8)
            s = np.full((vectors.shape[0],), gscale, np.float32)
        else:
            q, s = quantize_rows(vectors.astype(np.float32))
        qvec = chunked_put(q, 0, shape=(cap, q.shape[1]))
        qscale = jnp.asarray(pad_rows(s, 0))

    if hbm_vectors:
        # chunked upload: skips the full-size host astype/pad copies
        # (utils/transfer.py)
        vec_dev = chunked_put(vectors, 0,
                              shape=(cap, vectors.shape[1]),
                              dtype=store_dtype)
    else:
        dim = vectors.shape[1] if vectors.ndim == 2 and vectors.size else 1
        vec_dev = jnp.zeros((1, dim), jnp.float32)
    nbr_upper = upper_map = None
    if split_layers and nb.shape[0] > 1:
        # split device layout (DeviceGraph.nbr_upper): layer 0 at full
        # width, uppers truncated to upper_m (host upper rows never
        # carry more than the upper degree m — GraphConfig.max_degree)
        mu = upper_m if upper_m is not None else nb.shape[2]

        def pad3(a, fill):
            out = np.full((a.shape[0], cap, a.shape[2]), fill, a.dtype)
            out[:, : a.shape[1]] = a
            return out

        nb_dev = chunked_put(nb[0], -1, shape=(cap, nb.shape[2]))[None]
        if split_layers == "compact":
            # jagged per-layer tables indexed by level-descending rank:
            # layer l's nodes occupy rows [0, U_l) of EVERY table, so
            # each layer stores only its own occupancy (~N/3 rows total
            # instead of (L-1) * cap). See DeviceGraph.nbr_upper.
            lv = np.asarray(levels, np.int32)
            ups = np.flatnonzero(lv >= 1)
            ups = ups[np.argsort(-lv[ups], kind="stable")]
            umap = np.full((cap,), -1, np.int32)
            umap[ups] = np.arange(len(ups), dtype=np.int32)
            tabs = []
            for lyr in range(1, L):
                u_l = int((lv >= lyr).sum())
                # chunked upload with device-side -1 padding: layer 1 at
                # 16M nodes is ~4.2M occupied rows bucketed to 8.4M,
                # and the padding is never staged on the host
                tabs.append(chunked_put(
                    np.ascontiguousarray(nb[lyr][ups[:u_l], :mu]), -1,
                    shape=(bucket_pow2(max(u_l, 1)), mu)))
            nbr_upper = tuple(tabs)
            upper_map = jnp.asarray(umap)
        else:
            nbr_upper = jnp.asarray(pad3(nb[1:, :, :mu], -1))
    else:
        nb_dev = jnp.asarray(pad_rows(nb, -1))
    nbr_blocks = block_scale = None
    if block_layout and qvec is not None and nb_dev.shape[0]:
        if block_dtype == "auto":
            block_dtype = ("int8" if _int8_block_fit(
                vectors[: max(1, n)], metric=metric) >= 0.9
                else "float16")
        if block_dtype == "float16":
            # int8 cannot rank this data (tight clusters); gather the
            # blocks from a transient fp16 copy instead — 2x the block
            # bytes, full within-cluster resolution.
            h16 = chunked_put(vectors, 0,
                              shape=(cap, vectors.shape[1]),
                              dtype=np.float16)
            nbr_blocks = _gather_blocks(h16, nb_dev[0], block_m=block_m)
            del h16
            block_scale = jnp.asarray(np.float32(1.0))
        elif block_dtype == "int8":
            nbr_blocks = _gather_blocks(qvec, nb_dev[0], block_m=block_m)
            block_scale = jnp.asarray(np.float32(gscale))
        else:
            raise ValueError(f"bad block_dtype {block_dtype!r}")
    return DeviceGraph(
        vectors=vec_dev,
        sq_norms=jnp.asarray(pad_rows(sq_norms.astype(np.float32), 0)),
        neighbors=nb_dev,
        levels=jnp.asarray(pad_rows(levels.astype(np.int32), -1)),
        alive=jnp.asarray(pad_rows(al, False)),
        entry=jnp.asarray(np.int32(entry)),
        qvec=qvec,
        qscale=qscale,
        nbr_blocks=nbr_blocks,
        block_scale=block_scale,
        nbr_upper=nbr_upper,
        upper_map=upper_map,
    )


@functools.partial(jax.jit, static_argnames=("block_m",))
def _gather_blocks(qvec: jnp.ndarray, nb0: jnp.ndarray,
                   block_m: int | None = None) -> jnp.ndarray:
    """[cap, M0, D] int8 neighbor blocks via one device gather (rows for
    -1 edges are arbitrary — the search hop masks them by id).

    ``block_m`` < M0 truncates each block to the first block_m edges
    (rows are selection-ordered, best first) — the HBM knob that makes
    2M+ single-chip builds fit (full blocks are cap*M0*D bytes: 8.6 GB
    at 2M, M0=32, D=128)."""
    if block_m is not None and block_m < nb0.shape[1]:
        nb0 = nb0[:, :block_m]
    return qvec[jnp.clip(nb0, 0, qvec.shape[0] - 1)]
