"""Open-loop arrival schedules: Poisson processes under composable
rate shapes (docs/LOADGEN.md).

Closed-loop generators (send, wait, send again) suffer coordinated
omission: when the server stalls, the client stops *offering* load, so
queueing delay during the stall is never measured.  Everything here is
open-loop — the arrival schedule is drawn up front from a seeded
generator, and the client fires on that wall-clock schedule regardless
of how the server is doing.  Offered rate is a property of the
schedule, never of service time.

A *shape* is a pure ``rate(t)`` function (requests/s at offset ``t``
seconds into the run) plus its ``peak_rate()`` bound.  Schedules are
drawn by Lewis-Shedler thinning of a homogeneous Poisson process at
the peak rate, so any bounded shape — steady, diurnal ramp, flash
crowd — yields honest Poisson arrivals with the right local intensity.
Everything is deterministic from ``(shape, duration, seed)``: the same
call returns the identical schedule, byte for byte.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

__all__ = ["Steady", "DiurnalRamp", "FlashCrowd", "ShapeSum",
           "arrival_times", "interarrivals"]


class Steady:
    """Constant offered rate: the sustained-QPS legs."""

    def __init__(self, qps: float):
        if qps <= 0:
            raise ValueError(f"qps must be positive, got {qps}")
        self.qps = float(qps)

    def rate(self, t: float) -> float:
        return self.qps if t >= 0 else 0.0

    def peak_rate(self) -> float:
        return self.qps

    def __repr__(self) -> str:
        return f"Steady(qps={self.qps})"


class DiurnalRamp:
    """A smooth low→high→low swing: one raised-cosine period over
    ``period_s``, floored at ``low_qps`` and peaking at ``high_qps`` —
    the compressed day/night cycle the autoscaler must track without
    flapping."""

    def __init__(self, low_qps: float, high_qps: float, period_s: float):
        if not (0 < low_qps <= high_qps):
            raise ValueError(
                f"need 0 < low_qps <= high_qps, got {low_qps}/{high_qps}")
        if period_s <= 0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        self.low_qps = float(low_qps)
        self.high_qps = float(high_qps)
        self.period_s = float(period_s)

    def rate(self, t: float) -> float:
        if t < 0:
            return 0.0
        phase = 2.0 * math.pi * (t % self.period_s) / self.period_s
        frac = 0.5 * (1.0 - math.cos(phase))   # 0 at t=0, 1 at mid-period
        return self.low_qps + (self.high_qps - self.low_qps) * frac

    def peak_rate(self) -> float:
        return self.high_qps

    def __repr__(self) -> str:
        return (f"DiurnalRamp(low={self.low_qps}, high={self.high_qps}, "
                f"period_s={self.period_s})")


class FlashCrowd:
    """Steady base load with one rectangular burst: rate jumps to
    ``burst_qps`` during ``[at_s, at_s + dur_s)`` — the recovery-time
    legs measure how long after the burst ends p99 returns under SLO."""

    def __init__(self, base_qps: float, burst_qps: float,
                 at_s: float, dur_s: float):
        if base_qps <= 0 or burst_qps < base_qps:
            raise ValueError(
                f"need 0 < base_qps <= burst_qps, got {base_qps}/{burst_qps}")
        if at_s < 0 or dur_s <= 0:
            raise ValueError(f"bad burst window at={at_s} dur={dur_s}")
        self.base_qps = float(base_qps)
        self.burst_qps = float(burst_qps)
        self.at_s = float(at_s)
        self.dur_s = float(dur_s)

    def rate(self, t: float) -> float:
        if t < 0:
            return 0.0
        if self.at_s <= t < self.at_s + self.dur_s:
            return self.burst_qps
        return self.base_qps

    def peak_rate(self) -> float:
        return self.burst_qps

    def __repr__(self) -> str:
        return (f"FlashCrowd(base={self.base_qps}, burst={self.burst_qps}, "
                f"at_s={self.at_s}, dur_s={self.dur_s})")


class ShapeSum:
    """Superposition of shapes (Poisson processes are closed under
    superposition): e.g. a steady floor plus a flash crowd."""

    def __init__(self, shapes: Sequence):
        if not shapes:
            raise ValueError("ShapeSum needs at least one shape")
        self.shapes = list(shapes)

    def rate(self, t: float) -> float:
        return sum(s.rate(t) for s in self.shapes)

    def peak_rate(self) -> float:
        return sum(s.peak_rate() for s in self.shapes)

    def __repr__(self) -> str:
        return f"ShapeSum({self.shapes!r})"


def arrival_times(shape, duration_s: float, seed: int) -> np.ndarray:
    """Arrival offsets (seconds, ascending) for one run.

    Lewis-Shedler thinning: draw a homogeneous Poisson process at
    ``shape.peak_rate()`` and keep each candidate ``t`` with probability
    ``rate(t) / peak``.  Exact for any bounded intensity, and fully
    deterministic from ``seed`` (a fresh PCG64 stream per call — the
    schedule is reproducible across processes and sessions).
    """
    if duration_s <= 0:
        raise ValueError(f"duration_s must be positive, got {duration_s}")
    peak = float(shape.peak_rate())
    if peak <= 0:
        raise ValueError(f"shape peak rate must be positive, got {peak}")
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= duration_s:
            break
        # thinning: one uniform per candidate, drawn unconditionally so
        # the stream position (and thus the schedule) is deterministic
        u = rng.random()
        if u * peak <= shape.rate(t):
            out.append(t)
    return np.asarray(out, dtype=np.float64)


def interarrivals(times: np.ndarray) -> np.ndarray:
    """Gaps between consecutive arrivals (the Poisson property tests
    check mean ~= 1/qps and coefficient of variation ~= 1)."""
    times = np.asarray(times, dtype=np.float64)
    if times.size < 2:
        return np.empty(0, dtype=np.float64)
    return np.diff(times)
