"""Tracing / metering — the observability layer the reference lacks
(SURVEY.md §5: clock() calls with commented-out printfs, command echo).

Provides per-stage wall-clock + item counters (reads/s, gaps/s),
a JSON metrics dump per run, and an optional JAX profiler trace
context for device timelines.
"""

from __future__ import annotations

import contextlib
import json
import time


class Meters:
    def __init__(self):
        self.stages: dict[str, dict] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str, **counts):
        t0 = time.time()
        rec = self.stages.setdefault(name, {"seconds": 0.0})
        try:
            yield rec
        finally:
            dt = time.time() - t0
            rec["seconds"] += dt
            for k, v in counts.items():
                rec[k] = rec.get(k, 0) + v
                if v and dt > 0:
                    rec[f"{k}_per_s"] = rec[k] / rec["seconds"]

    def count(self, stage: str, **counts):
        rec = self.stages.setdefault(stage, {"seconds": 0.0})
        for k, v in counts.items():
            rec[k] = rec.get(k, 0) + v
            if rec["seconds"] > 0:
                rec[f"{k}_per_s"] = rec[k] / rec["seconds"]

    def summary(self) -> dict:
        return {"total_seconds": time.time() - self._t0,
                "stages": self.stages}

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)

    def report(self) -> str:
        lines = []
        for name, rec in self.stages.items():
            extras = " ".join(f"{k}={v:.1f}" if isinstance(v, float)
                              else f"{k}={v}"
                              for k, v in rec.items() if k != "seconds")
            lines.append(f"  {name}: {rec['seconds']:.2f}s {extras}")
        return "\n".join(lines)



def time_blocked(fn, reps: int = 5) -> float:
    """Median wall seconds of fn() over `reps` calls after one warm-up
    call; each call's result is waited for with jax.block_until_ready,
    so the time covers the device work, not just its dispatch."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """JAX profiler trace context (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import jax
    with jax.profiler.trace(logdir):
        yield
