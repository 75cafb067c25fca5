"""Lightweight per-phase wall-clock accounting for the frame path.

The reference scatters printf timers through its threads (e.g. the
t_solve/t_marg TicTocs in estimator.cpp:1124-1128 and the pose-graph
thread's own timers); here a single global registry accumulates
(count, total, max) per named phase so the e2e bench can publish an
attributed per-frame budget breakdown.

Zero-cost when disabled (one attribute check per phase); phases nest
freely — each phase records its own inclusive wall time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_ENABLED = False
_SAMPLES = defaultdict(list)  # name -> [dt_s, ...] (frame-path counts; tiny)


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def reset():
    _SAMPLES.clear()


@contextlib.contextmanager
def phase(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SAMPLES[name].append(time.perf_counter() - t0)


def add(name: str, dt: float):
    """Record an externally-timed interval."""
    if _ENABLED:
        _SAMPLES[name].append(dt)


def stats() -> dict:
    """{name: {count, total_ms, mean_ms, median_ms, max_ms}} snapshot.
    The median is the steady-state cost (immune to the one-off compile
    spikes that dominate mean/max on a fresh process)."""
    import numpy as np

    out = {}
    for name, xs in _SAMPLES.items():
        a = np.asarray(xs)
        out[name] = {
            "count": int(a.size),
            "total_ms": round(float(a.sum()) * 1e3, 2),
            "mean_ms": round(float(a.mean()) * 1e3, 3),
            "median_ms": round(float(np.median(a)) * 1e3, 3),
            "max_ms": round(float(a.max()) * 1e3, 2),
        }
    return out


def report(n_frames: int = 0) -> str:
    """Human-readable table, sorted by total time; with n_frames the
    per-frame amortized cost is shown (the number that must sum to the
    frame budget)."""
    rows = sorted(stats().items(), key=lambda kv: -kv[1]["total_ms"])
    lines = []
    for name, s in rows:
        per_frame = (
            f" {s['total_ms'] / max(n_frames, 1):8.2f} ms/frame"
            if n_frames
            else ""
        )
        lines.append(
            f"{name:<28} n={s['count']:<5} total={s['total_ms']:9.1f} ms "
            f"med={s['median_ms']:8.3f} ms mean={s['mean_ms']:8.3f} ms "
            f"max={s['max_ms']:8.1f} ms{per_frame}"
        )
    return "\n".join(lines)
