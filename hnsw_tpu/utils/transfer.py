"""Chunked host<->device transfers.

These helpers bound the size of every individual transfer (default
256 MB, env ``HNSW_TPU_CHUNK_MB``) and assemble the full array on the
far side:

- :func:`chunked_put` uploads row chunks into a preallocated device
  buffer via donated ``dynamic_update_slice`` — it also pads to a
  larger target shape device-side, and converts dtype per chunk, so
  callers never materialize a padded or converted GB-scale host copy
  first.
- :func:`chunked_get` pulls row chunks into a preallocated numpy
  buffer.

Whether chunking pays on a PCIe-attached GPU is not measured yet.
Reference analogue: none (the Go reference keeps everything in one
address space).
"""
from __future__ import annotations

import os

import numpy as np

_CHUNK_BYTES = int(os.environ.get("HNSW_TPU_CHUNK_MB", "256")) << 20

_UPDATERS: dict = {}


def _updater(ndim: int):
    """Module-cached donated row-updater per rank — a fresh jit wrapper
    per call would compile again on every invocation."""
    fn = _UPDATERS.get(ndim)
    if fn is None:
        import jax
        from jax import lax
        zeros = (0,) * (ndim - 1)
        fn = jax.jit(
            lambda b, c, i: lax.dynamic_update_slice(b, c, (i,) + zeros),
            donate_argnums=0)
        _UPDATERS[ndim] = fn
    return fn


def _row_bytes(shape, itemsize) -> int:
    n = itemsize
    for s in shape[1:]:
        n *= s
    return max(1, n)


def chunked_put(arr: np.ndarray, fill=0, shape=None, dtype=None,
                chunk_bytes: int | None = None):
    """Upload ``arr`` to the default device in bounded chunks.

    ``shape``/``fill`` optionally place the rows into a larger
    fill-padded device buffer (axis-0 prefix; trailing dims must
    match) — the padding happens on device, never as a host copy.
    ``dtype`` converts per-chunk (no full-size host astype).
    """
    import jax.numpy as jnp

    arr = np.asarray(arr)
    dtype = np.dtype(dtype if dtype is not None else arr.dtype)
    shape = tuple(shape) if shape is not None else arr.shape
    if shape[1:] != arr.shape[1:] or shape[0] < arr.shape[0]:
        raise ValueError(f"target shape {shape} cannot hold {arr.shape}")
    limit = chunk_bytes if chunk_bytes is not None else _CHUNK_BYTES
    row = _row_bytes(shape, dtype.itemsize)
    # the single-shot gate must bound the bytes that are TRANSFERRED —
    # the padded TARGET for the host-staged fast path, not the source
    # (a small array padded into a large capacity buffer would
    # otherwise ship the full buffer in one unbounded transfer)
    if shape[0] * row <= limit:
        if shape == arr.shape:
            return jnp.asarray(arr, dtype)
        out = np.full(shape, fill, dtype)
        out[: arr.shape[0]] = arr
        return jnp.asarray(out)
    # below: the padding is created device-side (jnp.full) and only the
    # source rows are transferred, in bounded chunks
    step = max(1, limit // row)
    # pow2 steps that divide a pow2-bucketed capacity keep the compiled
    # update-shape count at one
    step = 1 << (step.bit_length() - 1)
    step = min(step, shape[0])

    upd = _updater(len(shape))
    buf = jnp.full(shape, fill, dtype)
    n = arr.shape[0]
    for c0 in range(0, n, step):
        m = min(step, n - c0)
        chunk = np.asarray(arr[c0:c0 + m], dtype)
        if m < step and c0 + step <= shape[0]:
            # fixed chunk shape = one compile; fill-padding the tail is
            # idempotent (those buffer rows are `fill` already)
            pad = np.full((step,) + shape[1:], fill, dtype)
            pad[:m] = chunk
            chunk = pad
        buf = upd(buf, jnp.asarray(chunk), np.int32(c0))
    return buf


def chunked_get(dev, out: np.ndarray | None = None,
                chunk_bytes: int | None = None) -> np.ndarray:
    """Pull a device array to host in bounded chunks (axis-0 slices)."""
    limit = chunk_bytes if chunk_bytes is not None else _CHUNK_BYTES
    shape = tuple(dev.shape)
    dtype = np.dtype(dev.dtype)
    if out is None:
        out = np.empty(shape, dtype)
    if not shape or out.nbytes <= limit:
        out[...] = np.asarray(dev)
        return out
    step = max(1, limit // _row_bytes(shape, dtype.itemsize))
    for c0 in range(0, shape[0], step):
        m = min(step, shape[0] - c0)
        out[c0:c0 + m] = np.asarray(dev[c0:c0 + m])
    return out
