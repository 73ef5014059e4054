"""Roofline / MFU accounting for the exact-scan tiers.

Two fields per exact-tier row:
  * ``mfu``        — achieved FLOP/s over the card's published dense peak
    for the precision the row's matmul ran at (:data:`PEAKS`, keyed by
    ``device_kind``). A device missing from the table is an error.
  * ``floor_frac`` — achieved time over the measured scan-only matmul
    floor ON THIS RUN's device and shapes (the relative roofline: the
    selection/rerank overhead is exactly 1 - floor_frac).

A card set below its full power limit cannot hold its top clock under a
matmul-heavy load, so a row's ``mfu`` is read with the card's
``nvidia-smi`` power limit beside it.
"""

from __future__ import annotations

import time
from typing import Optional

#: Dense (no sparsity) peak rates per card, FLOP/s, and device-memory
#: bandwidth, bytes/s. Source: NVIDIA H100 Tensor Core GPU data sheet
#: (SXM5 and PCIe columns); the published rates assume the full power
#: limit (700 W SXM, 350 W PCIe).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                              "fp32": 67e12, "hbm_bytes_per_s": 3.35e12},
    "NVIDIA H100 PCIe": {"bf16": 756e12, "tf32": 378e12,
                         "fp32": 51e12, "hbm_bytes_per_s": 2.0e12},
}


def peak(device_kind: str, precision: str) -> float:
    """Published peak of ``device_kind`` at ``precision`` (``"bf16"``,
    ``"tf32"``, ``"fp32"`` or ``"hbm_bytes_per_s"``)."""
    try:
        row = PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak table entry for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None
    return row[precision]


def scan_flops(n_q: int, n: int, d: int) -> float:
    """FLOPs of one exact Gram scan: the [n_q, d] x [d, n] matmul."""
    return 2.0 * n_q * n * d


def matmul_floor_dt(queries, vectors, *, fast_math: bool,
                    reps: int = 5, chunk: int = 65536) -> float:
    """Median seconds of the BARE Gram matmul on the given device
    arrays — the scan-only ceiling every epilogue/selection rides on.
    Uses the same precision the measured config used (fast_math =
    bf16 inputs at DEFAULT, else f32 at HIGHEST).

    Chunked over rows with a [Q]-sized max epilogue per chunk: the full
    [Q, N] Gram is 32 GB at B=8192, N=1M — the floor must be measurable
    at exactly the Ns where it matters. The reduce is cheap next to the
    matmul, and chunking matches the production scan's layout."""
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("fast",))
    def gram_max(a, b, fast):
        if fast:
            a = a.astype(jnp.bfloat16)
            b = b.astype(jnp.bfloat16)
        g = jnp.einsum("qd,nd->qn", a, b,
                       precision=(jax.lax.Precision.DEFAULT if fast
                                  else jax.lax.Precision.HIGHEST),
                       preferred_element_type=jnp.float32)
        return jnp.max(g, axis=1)

    n = vectors.shape[0]
    starts = list(range(0, n, chunk))

    def run():
        outs = [gram_max(queries, vectors[c:c + chunk], fast_math)
                for c in starts]
        jax.block_until_ready(outs)

    run()  # compile both chunk shapes (full + ragged tail) + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def roofline_fields(*, n_q: int, n: int, d: int, dt: float,
                    device_kind: str, precision: str,
                    floor_dt: Optional[float] = None) -> dict:
    """The ratio fields for a measured exact-scan row (dt seconds for
    one batch of n_q queries over n rows, matmul at ``precision``)."""
    fl = scan_flops(n_q, n, d)
    out = {"achieved_tflops": fl / dt / 1e12,
           "mfu": fl / dt / peak(device_kind, precision),
           "mfu_precision": precision}
    if floor_dt is not None and dt > 0:
        out["floor_frac"] = floor_dt / dt
    return out
