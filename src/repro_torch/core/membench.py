"""Measurement infrastructure mirroring the paper's methodology (§III-B).

Counterpart of ``repro/core/membench.py``.  The paper's rules:

* a *kernel* is the measured function, excluding sync and measurement code;
* every number is the average of ``repeats`` measurements after discarding
  ``warmup`` runs.

On ``cuda`` each repeat is timed with CUDA events recorded on the current
stream around ``fn``, the paper's GPU method (the card's own clock, no
host synchronisation inside the interval).  A spin kernel ahead of the
timed calls keeps the card busy while the host enqueues all of them, so
each event pair spans the card's time for its call and not the host's
launch overhead, which would otherwise be timed whenever a call is
shorter on the card than on the host (tens of µs for a small read).  On
``cpu`` the timer is ``time.perf_counter``; PyTorch's CPU ops finish
before they return.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class Measurement:
    name: str
    mean_s: float
    min_s: float
    max_s: float
    std_s: float
    repeats: int
    nbytes: float = 0.0
    flops: float = 0.0

    @property
    def bandwidth(self) -> float:
        """bytes/s, using the mean (paper reports averages)."""
        return self.nbytes / self.mean_s if self.mean_s else 0.0

    @property
    def gbps(self) -> float:
        return self.bandwidth / 1e9

    @property
    def tflops(self) -> float:
        return self.flops / self.mean_s / 1e12 if self.mean_s else 0.0

    @property
    def us_per_call(self) -> float:
        return self.mean_s * 1e6

    def csv(self, derived: str | None = None) -> str:
        d = derived
        if d is None:
            d = f"{self.gbps:.2f}GB/s" if self.nbytes else f"{self.tflops:.2f}TF/s"
        return f"{self.name},{self.us_per_call:.2f},{d}"


#: SM clock cycles a second the spin kernel is sized with (the H100's
#: 1.98 GHz maximum; a slower clock only lengthens the spin)
_SPIN_HZ = 1.98e9
#: the longest spin, in seconds
_SPIN_MAX_S = 2.0


def _times(fn: Callable[[], Any], warmup: int, repeats: int,
           device: torch.device) -> list[float]:
    host = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
        # spin for twice the host time the timed calls take to enqueue (the
        # fastest warm-up call's, so a first call that loads a library does
        # not count) plus 100 us, at most _SPIN_MAX_S
        spin_s = min(2 * repeats * min(host, default=0.0) + 1e-4, _SPIN_MAX_S)
        torch.cuda._sleep(int(_SPIN_HZ * spin_s))
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(device)
        return [start.elapsed_time(end) / 1e3 for start, end in events]
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return times


def measure(
    fn: Callable[[], Any],
    *,
    name: str = "",
    warmup: int = 1,
    repeats: int = 10,
    nbytes: float = 0.0,
    flops: float = 0.0,
    device: str | torch.device | None = None,
) -> Measurement:
    """Time ``fn`` with the paper's warmup-then-average protocol on
    ``device`` (default ``cuda``): CUDA events around each call there,
    ``perf_counter`` on the CPU."""
    dev = resolve_device(device)
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        times = _times(fn, warmup, repeats, dev)
    return Measurement(
        name=name or getattr(fn, "__name__", "kernel"),
        mean_s=statistics.fmean(times),
        min_s=min(times),
        max_s=max(times),
        std_s=statistics.pstdev(times) if len(times) > 1 else 0.0,
        repeats=repeats,
        nbytes=nbytes,
        flops=flops,
    )


def dispatch_overhead(repeats: int = 50,
                      device: str | torch.device | None = None) -> float:
    """Seconds of host time per launched no-op (an in-place add of 0 to a
    one-element tensor on ``device``), over ``repeats`` launches ending in
    a synchronise: the timer-resolution analogue of the paper's 32 ns
    clock-read experiment."""
    dev = resolve_device(device)
    x = torch.zeros(1, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x.add_(0)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        x.add_(0)
    sync()
    return (time.perf_counter() - t0) / repeats


def linear_fit(
    measurements: Sequence[Measurement],
) -> tuple[float, float]:
    """Least-squares fit ``t = latency + nbytes / bandwidth`` over a size
    sweep; returns ``(latency_s, bandwidth_Bps)``.

    This is how calibration separates the two terms a single measurement
    conflates (paper Figs. 11-13 vs 7-8: small buffers expose latency,
    large buffers expose bandwidth).  Degenerate sweeps (single size, or a
    non-positive slope from noisy timings) fall back to the largest-size
    measurement's effective bandwidth with zero latency.
    """
    pts = [(float(m.nbytes), m.mean_s) for m in measurements if m.nbytes]
    if not pts:
        raise ValueError("linear_fit needs measurements with nbytes set")
    big = max(measurements, key=lambda m: m.nbytes)
    if len(pts) < 2:
        return 0.0, big.bandwidth
    n = len(pts)
    mean_x = sum(x for x, _ in pts) / n
    mean_y = sum(y for _, y in pts) / n
    sxx = sum((x - mean_x) ** 2 for x, _ in pts)
    sxy = sum((x - mean_x) * (y - mean_y) for x, y in pts)
    if sxx <= 0.0 or sxy <= 0.0:
        return 0.0, big.bandwidth
    slope = sxy / sxx                       # s per byte
    intercept = mean_y - slope * mean_x     # s
    return max(intercept, 0.0), 1.0 / slope


def sweep(
    fn_of_size: Callable[[int], Callable[[], Any]],
    sizes: Sequence[int],
    *,
    name: str,
    warmup: int = 1,
    repeats: int = 10,
    bytes_of_size: Callable[[int], float] | None = None,
    device: str | torch.device | None = None,
) -> list[Measurement]:
    """Buffer-size sweep (the x-axis of paper Figs. 8, 10, 12, 14, 18-19)."""
    out = []
    for size in sizes:
        fn = fn_of_size(size)
        out.append(
            measure(
                fn,
                name=f"{name}[{size}]",
                warmup=warmup,
                repeats=repeats,
                nbytes=bytes_of_size(size) if bytes_of_size else float(size),
                device=device,
            )
        )
    return out
