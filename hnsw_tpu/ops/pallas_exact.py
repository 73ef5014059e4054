"""Fused exact-scan + top-k kernel for Hopper GPUs (Pallas, Triton route).

One kernel computes distances AND keeps each query's running top-k in
registers, so the [Q, N] score matrix never reaches device memory. The
plain XLA scan (``ops/topk.exact_topk``) writes a [Q, chunk] f32 score
block per chunk and reads it back for ``lax.top_k``: at B = 8192 and a
65,536-row chunk that is 2 GiB each way per chunk. A matrix product
followed by a top-k is a pattern XLA does not fuse.

Layout: grid (query tiles, N splits), both parallel — no carry between
blocks, so even B = 1024 fills the card's SMs through the N splits.
Inside a block a ``fori_loop`` walks the split's column tiles:

1. ``pl.dot`` of the [TQ, D] query tile with a [TC, D] vector tile
   (bf16 operands on the fast path; TF32x3 for f32 — both accumulate in
   f32);
2. a ranking-equivalent epilogue (per-query constants dropped: they do
   not change a row's order);
3. PACKED-KEY selection: each f32 key is mapped to an order-preserving
   int32 whose low log2(TC) bits are replaced by the column id, so one
   min-reduce yields both the best key and its column;
4. a ``while_loop`` that inserts a tile's keys into the running set
   only while some row's tile minimum beats that row's current k_sel-th
   key. Late tiles rarely hold a winner for any row of the block, so
   most tiles cost one reduction and no extraction pass.

Each block writes its k_sel partial winners; the final merge over the N
splits and the f32 rerank (``Precision.HIGHEST``) run in XLA
(:func:`exact_topk_fused`), so reported distances and order are f32-exact.

Precision margin: packing costs at most 2^-16 of a key's magnitude, and
the screen's matmul error is ~2^-9 (bf16) or ~2^-21 (TF32x3) of |q||v|.
The true top-k only has to survive into the k_sel = next_pow2(k + 6)
screened candidates, which the f32 rerank then orders exactly.

This is the role viterin/vek's SIMD assembly plays in the reference
(distance.go:8; SURVEY.md §2.8) — the one place it drops to native.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from hnsw_tpu.config import canonical_metric
from hnsw_tpu.ops.distance import INF_DIST

_INT32_MIN = np.int32(-2147483648)
_INT32_MAX = np.int32(2147483647)

#: int32 keys at or above this are masked rows / unfilled slots.
_INVALID_KEY_FLOOR = int(
    np.int32(np.float32(INF_DIST).view(np.int32)) & ~0xFFFF)

#: metrics the kernel's epilogue implements.
FUSED_METRICS = ("cosine", "l2", "sqeuclidean", "dot")
#: widest running set a block keeps in registers.
MAX_KSEL = 128
#: smallest store (rows) at which ExactIndex takes the fused kernel on a
#: GPU: the smallest N measured, where it already beat XLA's scan 2.8x
#: (B = 1024) to 9.4x (B = 8192) on an H100. Smaller stores keep XLA's
#: single-chunk scan until measured.
FUSED_MIN_ROWS = 16384

# Tiles: TQ query rows x TC vector rows per step. Powers of two for
# Triton; a [64, 128] f32 score tile plus its int32 keys is 64 KB of
# registers over 4 warps, and the pipelined [TC, D] vector tiles stay
# far inside 227 KB of shared memory at D <= 512.
TQ = 64
TC = 128
NUM_WARPS = 4
NUM_STAGES = 3
#: blocks to aim for: two per SM of an H100 (132 SMs).
_TARGET_BLOCKS = 264


def ksel_for(k: int) -> int:
    """Screened candidates per query for a final top-k."""
    return max(16, 1 << int(np.ceil(np.log2(k + 6))))


def fused_applies(platform: str, n_rows: int, k: int, metric: str) -> bool:
    """Whether ExactIndex serves an f32-store scan with the fused kernel.

    Only a GPU compiles it (Triton); the interpreter is for tests. Small
    stores stay on XLA's scan (``FUSED_MIN_ROWS``)."""
    return (platform == "gpu" and n_rows >= FUSED_MIN_ROWS
            and ksel_for(k) <= MAX_KSEL
            and canonical_metric(metric) in FUSED_METRICS)


def scan_topk(queries, vectors, v_sq, valid, *, k: int, metric: str,
              fast_math: bool = False):
    """Exact k-NN by the scan this platform serves best: the fused
    kernel where :func:`fused_applies`, XLA's chunked
    ``ops/topk.exact_topk`` elsewhere. Same results either way."""
    from hnsw_tpu.ops.topk import exact_topk
    if fused_applies(jax.devices()[0].platform, vectors.shape[0], k, metric):
        return exact_topk_fused(queries, vectors, v_sq, valid, k=k,
                                metric=metric, fast_math=fast_math)
    return exact_topk(queries, vectors, v_sq, valid, k=k, metric=metric,
                      fast_math=fast_math)


def _mono_int32(d: jnp.ndarray) -> jnp.ndarray:
    """Order-preserving f32 -> int32 map (finite inputs).

    Non-negative floats keep their bit pattern (already increasing);
    negative floats map to INT32_MIN - bits (mirrors them below zero).
    """
    u = jax.lax.bitcast_convert_type(d, jnp.int32)
    return jnp.where(u >= 0, u, _INT32_MIN - u)


def _make_kernel(metric: str, k_sel: int, tc: int, n_tiles: int,
                 fast_math: bool, interpret: bool):
    col_mask = np.int32(tc - 1)
    clear_mask = np.int32(~(tc - 1))
    if fast_math:
        precision = None
    elif interpret:
        # the CPU interpreter has no TF32; it computes the same screen
        # at f32, which only tightens the margin
        precision = jax.lax.Precision.HIGHEST
    else:
        precision = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3

    def kernel(q_ref, v_ref, vsq_ref, outk_ref, outi_ref):
        split = pl.program_id(1)
        q = q_ref[...]                                  # [TQ, D] f32
        tq = q.shape[0]
        if fast_math:
            q = q.astype(jnp.bfloat16)
        cols = jax.lax.broadcasted_iota(jnp.int32, (tq, tc), 1)
        slots = jax.lax.broadcasted_iota(jnp.int32, (tq, k_sel), 1)
        split_base = split * (n_tiles * tc)

        def tile(t, carry):
            run_k, run_i, thr = carry
            v = v_ref[pl.ds(t * tc, tc), :]              # [TC, D]
            vsq = vsq_ref[pl.ds(t * tc, tc)]             # [TC]; < 0 = masked
            if fast_math:
                v = v.astype(jnp.bfloat16)
            g = pl.dot(q, v, trans_b=True, precision=precision)
            if metric == "dot":
                key = -g
            elif metric == "cosine":        # |q| is a per-row constant
                key = -g * jax.lax.rsqrt(jnp.maximum(vsq, 0.0)
                                         + 1e-30)[None, :]
            else:                       # l2 / sqeuclidean: |q|^2 dropped
                key = vsq[None, :] - 2.0 * g
            pk = (_mono_int32(key) & clear_mask) | cols
            pk = jnp.where(vsq[None, :] >= 0.0, pk, _INT32_MAX)
            m = jnp.min(pk, axis=1)
            tile_base = split_base + t * tc

            def pending(c):
                return jnp.max(jnp.where(c[4] < c[2], 1, 0)) > 0

            def insert(c):
                run_k, run_i, thr, pk, m = c
                need = (m < thr)[:, None]
                pos = jnp.argmax(run_k, axis=1)          # current worst
                hit = (slots == pos[:, None]) & need
                run_k = jnp.where(hit, m[:, None], run_k)
                run_i = jnp.where(hit, (tile_base + (m & col_mask))[:, None],
                                  run_i)
                thr = jnp.max(run_k, axis=1)
                pk = jnp.where(pk == m[:, None], _INT32_MAX, pk)
                return run_k, run_i, thr, pk, jnp.min(pk, axis=1)

            run_k, run_i, thr, _, _ = jax.lax.while_loop(
                pending, insert, (run_k, run_i, thr, pk, m))
            return run_k, run_i, thr

        init = (jnp.full((tq, k_sel), _INT32_MAX, jnp.int32),
                jnp.full((tq, k_sel), -1, jnp.int32),
                jnp.full((tq,), _INT32_MAX, jnp.int32))
        run_k, run_i, _ = jax.lax.fori_loop(0, n_tiles, tile, init)
        outk_ref[...] = run_k
        outi_ref[...] = run_i

    return kernel


def plan(n_q: int, n: int, d: int) -> Tuple[int, int, int, int]:
    """(padded Q, padded D, N splits, padded N) for a launch.

    Splits N until the grid holds about two blocks per SM; each split is
    a whole number of TC tiles."""
    q_pad = -(-n_q // TQ) * TQ
    d_pad = max(16, 1 << int(np.ceil(np.log2(max(d, 1)))))
    n_tiles_total = -(-n // TC)
    splits = 1
    while (splits * 2 * (q_pad // TQ) <= _TARGET_BLOCKS
           and splits * 2 <= n_tiles_total):
        splits *= 2
    n_pad = -(-n_tiles_total // splits) * splits * TC
    return q_pad, d_pad, splits, n_pad


@functools.partial(jax.jit,
                   static_argnames=("k_sel", "metric", "splits",
                                    "interpret", "fast_math"))
def fused_screen(queries: jnp.ndarray, vectors: jnp.ndarray,
                 vsq_masked: jnp.ndarray, *, k_sel: int, metric: str,
                 splits: int, interpret: bool = False,
                 fast_math: bool = False
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Screening pass: per-split winners (keys [Q, splits*k_sel], ids).

    queries [Q, D] f32 and vectors [N, D] with Q % TQ == 0, N % (splits *
    TC) == 0 and D a power of two >= 16 (see :func:`plan`).
    ``vsq_masked`` holds squared norms, negative for masked rows. Keys at
    or above ``_INVALID_KEY_FLOOR`` mark empty slots."""
    q_n, d = queries.shape
    n = vectors.shape[0]
    assert q_n % TQ == 0 and n % (splits * TC) == 0, (q_n, n, splits)
    ns = n // splits
    kernel = _make_kernel(metric, k_sel, TC, ns // TC, fast_math, interpret)
    return pl.pallas_call(
        kernel,
        grid=(q_n // TQ, splits),
        in_specs=[
            pl.BlockSpec((TQ, d), lambda i, s: (i, 0)),
            pl.BlockSpec((ns, d), lambda i, s: (s, 0)),
            pl.BlockSpec((ns,), lambda i, s: (s,)),
        ],
        out_specs=[
            pl.BlockSpec((TQ, k_sel), lambda i, s: (i, s)),
            pl.BlockSpec((TQ, k_sel), lambda i, s: (i, s)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((q_n, splits * k_sel), jnp.int32),
            jax.ShapeDtypeStruct((q_n, splits * k_sel), jnp.int32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="exact_scan_topk",
    )(queries, vectors, vsq_masked)


@functools.partial(jax.jit,
                   static_argnames=("k", "metric", "interpret", "fast_math"))
def exact_topk_fused(queries, vectors, v_sq, valid, *, k: int,
                     metric: str = "cosine", interpret: bool = False,
                     fast_math: bool = False):
    """Fused exact k-NN: kernel screening + f32 rerank of the winners.

    Same signature and results as ``ops/topk.exact_topk``: (dists [Q, k],
    idx [Q, k]) with f32-exact distances and order; rows beyond the valid
    count get INF_DIST / -1. Requires ``ksel_for(k) <= MAX_KSEL``."""
    metric = canonical_metric(metric)
    if metric not in FUSED_METRICS:
        raise ValueError(f"fused scan does not implement metric {metric!r}")
    k_sel = ksel_for(k)
    if k_sel > MAX_KSEL:
        raise ValueError(f"fused scan supports k <= {MAX_KSEL - 6}, got {k}")
    queries = jnp.asarray(queries, jnp.float32)
    q_n, d = queries.shape
    n = vectors.shape[0]
    q_pad, d_pad, splits, n_pad = plan(q_n, n, d)
    vsq_masked = jnp.where(valid, v_sq.astype(jnp.float32), -1.0)
    qp = jnp.pad(queries, ((0, q_pad - q_n), (0, d_pad - d)))
    vp, sp = vectors, vsq_masked
    if n_pad != n or d_pad != d:
        vp = jnp.pad(vectors, ((0, n_pad - n), (0, d_pad - d)))
        sp = jnp.pad(vsq_masked, (0, n_pad - n), constant_values=-1.0)
    keys, ids = fused_screen(qp, vp, sp, k_sel=k_sel, metric=metric,
                             splits=splits, interpret=interpret,
                             fast_math=fast_math)
    keys, ids = keys[:q_n], ids[:q_n]
    if splits > 1:                       # merge the splits' winners
        neg, pos = jax.lax.top_k(-keys, k_sel)
        keys = -neg
        ids = jnp.take_along_axis(ids, pos, axis=1)
    ok = (keys < _INVALID_KEY_FLOOR) & (ids >= 0)

    # f32 rerank of the k_sel-wide pool (exact reported distances)
    from hnsw_tpu.ops.distance import gathered_dist
    safe = jnp.clip(ids, 0, n - 1)
    cv = vectors[safe].astype(jnp.float32)              # [Q, k_sel, D]
    csq = v_sq[safe]
    q_sq = jnp.sum(queries * queries, axis=-1)
    dist = gathered_dist(queries, cv, csq, q_sq, metric=metric,
                         precision=jax.lax.Precision.HIGHEST)
    dist = jnp.where(ok, dist, INF_DIST)
    neg, pos = jax.lax.top_k(-dist, k)          # k_sel >= k + 6
    dk = -neg
    ik = jnp.take_along_axis(ids, pos, axis=1)
    ik = jnp.where(dk >= INF_DIST, -1, ik)
    return dk, ik
