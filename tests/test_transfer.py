"""Chunked host<->device transfers (utils/transfer.py).

Tiny chunk_bytes force the multi-chunk path; correctness = bit-exact
round trips including device-side fill padding and per-chunk dtype
conversion. No reference analogue (transfer plumbing).
"""
import numpy as np
import pytest

from hnsw_tpu.utils.transfer import chunked_get, chunked_put


@pytest.mark.parametrize("n,pad", [(100, 128), (128, 128), (7, 32)])
def test_put_pads_on_device(n, pad):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, 16)).astype(np.float32)
    dev = chunked_put(a, fill=0, shape=(pad, 16), chunk_bytes=1024)
    out = np.asarray(dev)
    assert out.shape == (pad, 16)
    np.testing.assert_array_equal(out[:n], a)
    assert (out[n:] == 0).all()


def test_put_fill_and_dtype_conversion():
    a = np.arange(50, dtype=np.int64).reshape(10, 5)
    dev = chunked_put(a, fill=-1, shape=(16, 5), dtype=np.int32,
                      chunk_bytes=64)
    out = np.asarray(dev)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out[:10], a)
    assert (out[10:] == -1).all()


def test_put_single_chunk_fastpath():
    a = np.ones((4, 4), np.float32)
    dev = chunked_put(a)
    np.testing.assert_array_equal(np.asarray(dev), a)


def test_put_rejects_bad_shape():
    a = np.ones((4, 4), np.float32)
    with pytest.raises(ValueError):
        chunked_put(a, shape=(2, 4))
    with pytest.raises(ValueError):
        chunked_put(a, shape=(8, 5))


def test_get_round_trip():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    a = rng.standard_normal((37, 8)).astype(np.float32)
    dev = jnp.asarray(a)
    out = chunked_get(dev, chunk_bytes=256)
    np.testing.assert_array_equal(out, a)
    # preallocated output buffer path
    buf = np.empty((37, 8), np.float32)
    out2 = chunked_get(dev, out=buf, chunk_bytes=256)
    assert out2 is buf
    np.testing.assert_array_equal(buf, a)


def test_get_scalarish():
    import jax.numpy as jnp
    dev = jnp.float32(3.5)
    assert chunked_get(dev) == np.float32(3.5)


def test_put_gate_bounds_padded_target_not_source():
    """A small source padded into a large target must ride the chunked
    path (device-side fill) — the single-shot gate bounds the bytes
    transferred, i.e. the PADDED buffer, not the source."""
    a = np.arange(3 * 4, dtype=np.float32).reshape(3, 4)
    # target = 64 rows x 16 B = 1024 B > 64 B limit; source = 48 B
    dev = chunked_put(a, fill=-1, shape=(64, 4), chunk_bytes=64)
    out = np.asarray(dev)
    np.testing.assert_array_equal(out[:3], a)
    assert (out[3:] == -1).all()


def test_put_small_source_large_target_dtype():
    a = np.linspace(-2, 2, 20, dtype=np.float32).reshape(5, 4)
    dev = chunked_put(a, fill=0, shape=(128, 4), dtype=np.float16,
                      chunk_bytes=128)
    out = np.asarray(dev)
    np.testing.assert_array_equal(out[:5], a.astype(np.float16))
    assert (out[5:] == 0).all()
