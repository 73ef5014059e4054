"""Default-on build heartbeat.

The reference surfaces background-build errors/progress through its
notification channel (/root/reference/hnsw-extensions/parquet/graph.go:1107);
this repo's equivalent is a stderr heartbeat. Rationale: a multi-hour
device build with progress prints gated OFF looks hung (frozen client
CPU during device compute, D2H bursts only at checkpoints), and a
healthy build taken for a hung one gets killed. The heartbeat belongs
in the code path, not in operator discipline.

HNSW_TPU_BUILD_PROGRESS:
  unset -> throttled heartbeat (at most one line per ``every_s``,
           plus checkpoint notices) — the default.
  "1"   -> verbose: a line per wave/slice.
  "0"   -> silent (tests, tight benchmark loops).
"""
from __future__ import annotations

import os
import sys
import time


class BuildHeartbeat:
    def __init__(self, total: int, label: str,
                 every_s: float = 30.0) -> None:
        mode = os.environ.get("HNSW_TPU_BUILD_PROGRESS", "")
        self.silent = mode == "0"
        self.verbose = mode == "1"
        self.total = int(total)
        self.label = label
        self.every_s = every_s
        self.t0 = time.perf_counter()
        self._last = self.t0

    def due(self) -> bool:
        """True when a progress line should be emitted now. Callers may
        gate an expensive sync (e.g. block_until_ready, so the printed
        count reflects completed device work, not enqueued work) behind
        this check."""
        if self.silent:
            return False
        if self.verbose:
            return True
        return time.perf_counter() - self._last >= self.every_s

    def emit(self, done: int, extra: str = "") -> None:
        now = time.perf_counter()
        dt = now - self.t0
        rate = done / dt if dt > 0 else 0.0
        print(f"# {self.label}: {done}/{self.total} "
              f"({rate:.0f} nodes/s, {dt:.0f}s elapsed){extra}",
              file=sys.stderr, flush=True)
        self._last = now

    def checkpoint(self, path: str) -> None:
        """Announce a checkpoint write — the 'is it alive?' signal an
        operator checks file mtimes for; print it even in throttled
        mode so checkpoints are never silent."""
        if self.silent:
            return
        try:
            sz = os.path.getsize(path) / 2**30
            note = f" ({sz:.1f} GB)"
        except OSError:
            note = ""
        print(f"# {self.label}: checkpoint saved -> {path}{note}",
              file=sys.stderr, flush=True)
