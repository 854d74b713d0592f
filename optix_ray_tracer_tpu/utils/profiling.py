"""Per-stage timing + throughput metrics (rays/sec, spp/sec) with optional
JSONL emission and jax.profiler hooks.

The reference has no profiling beyond its frame pacer
(``SDL_GraphicsWindow.cu:265-274``) and suggests MangoHud externally
(docs/configuration.md:29); this framework makes observability
first-class (SURVEY.md section 5.1/5.5).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulating wall-clock timers per named stage.

    Use ``block=True`` (default) to synchronize the device before stopping
    the clock — otherwise XLA's async dispatch makes stages look free.
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block:
                try:
                    jax.block_until_ready(jax.device_put(0.0))
                except Exception:
                    pass
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


class MetricsLogger:
    """JSONL metrics sink: one json object per line (rays/sec, build times,
    frame times...)."""

    def __init__(self, path: str | None = None) -> None:
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, **fields) -> None:
        fields.setdefault("ts", time.time())
        if self._f:
            self._f.write(json.dumps(fields) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def rays_per_second(width: int, height: int, spp: int, depth: int,
                    seconds: float) -> float:
    """Upper-bound ray count (every path reaching full depth); reported
    alongside actual traced-segment counts when available."""
    return width * height * spp * depth / max(seconds, 1e-12)


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """Wrap a region in a jax.profiler trace when a logdir is given."""
    if logdir:
        with jax.profiler.trace(logdir):
            yield
    else:
        yield
