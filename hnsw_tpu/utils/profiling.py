"""Profiling / tracing hooks — aux-subsystem parity (SURVEY.md §5).

The reference leans on Go's pprof + the adaptive selector's query
telemetry; here the equivalents are the JAX profiler (device traces
viewable in TensorBoard/Perfetto) plus host-side timed sections that
feed telemetry.MetricsWindow.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


def card_name_and_power() -> str:
    """``name, power.limit`` of the first GPU as ``nvidia-smi`` reports
    it, read by a child process that stays off JAX."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_header(require_gpu: bool = True) -> dict:
    """What a measurement ran on: JAX's platform, device kind and device
    count, plus the card's name and power limit. Raises RuntimeError
    when ``require_gpu`` and JAX found no GPU — a measurement path does
    not fall back to the CPU."""
    import jax
    devs = jax.devices()
    platform = devs[0].platform
    if require_gpu and platform != "gpu":
        raise RuntimeError(f"no GPU found (JAX platform {platform!r})")
    return {"platform": platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "card": card_name_and_power() if platform == "gpu" else None}


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a JAX device profile (open in TensorBoard/Perfetto)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Named wall-clock sections with simple aggregates."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "avg_ms": round(1000 * self.totals[name]
                                / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }


def annotate(name: str):
    """Decorator adding a named XLA trace annotation to a function
    (shows up in device profiles)."""
    import jax

    def deco(fn):
        def wrapper(*a, **k):
            with jax.profiler.TraceAnnotation(name):
                return fn(*a, **k)
        wrapper.__name__ = getattr(fn, "__name__", name)
        return wrapper

    return deco
