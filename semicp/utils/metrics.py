"""Structured metrics + phase timing — the observability subsystem.

Reference counterpart: std::cout prints of iteration counts and
std::chrono wall-clock timings in the driver mains (SURVEY.md §5
"Metrics / logging" and "Tracing / profiling"). Upgraded to structured
JSONL per-frame records (the input to BASELINE measurements) plus a
per-phase timer table.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL writer for per-frame records."""

    def __init__(self, path: str | Path | None):
        self.path = Path(path) if path else None
        self._fh = open(self.path, "a") if self.path else None
        self.records: list[dict] = []

    def log(self, **record):
        record.setdefault("t_wall", time.time())
        self.records.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name.

    JAX dispatches asynchronously: callers end each device phase with
    `jax.block_until_ready(output)` so the phase times the work, not
    its enqueue.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def table(self) -> str:
        lines = [f"{'phase':<24}{'count':>8}{'total s':>12}{'mean ms':>12}"]
        for k, v in sorted(self.summary().items()):
            lines.append(f"{k:<24}{v['count']:>8}{v['total_s']:>12.3f}{v['mean_ms']:>12.2f}")
        return "\n".join(lines)
