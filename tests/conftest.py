"""Test configuration: run on a virtual 8-device CPU mesh.

The tests run on the CPU (a multi-card GPU host is not available in
CI); sharding tests run against XLA's host-platform device emulation.
This must happen before jax is imported anywhere. Tests marked ``gpu``
need a card: the ``gpu_device`` fixture skips them here, and
``chip_smoke.py`` runs the same paths on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip. Decided when the test runs, never at
    import: every xdist worker must collect the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; run chip_smoke.py on the card")
    return gpus[0]


def make_vectors(n: int, dim: int, seed: int = 0, kind: str = "random"):
    """Dataset generators mirroring the reference benchmark shapes
    (hybrid/benchmark_test.go:40-112): random / clustered / skewed."""
    r = np.random.default_rng(seed)
    if kind == "random":
        return r.standard_normal((n, dim)).astype(np.float32)
    if kind == "clustered":
        n_clusters = max(1, n // 100)
        centers = r.standard_normal((n_clusters, dim)).astype(np.float32) * 5
        asg = r.integers(0, n_clusters, n)
        return (centers[asg] +
                0.3 * r.standard_normal((n, dim)).astype(np.float32))
    if kind == "skewed":
        v = r.standard_normal((n, dim)).astype(np.float32)
        v[:, : dim // 4] *= 10.0
        return v
    raise ValueError(kind)
