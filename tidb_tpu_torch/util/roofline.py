"""Per-query roofline accounting (PAPER.md §roofline; bench.py's
device-roofline section generalized to every statement).

A scan-bound query's floor is `bytes the program must move / sustained
stream bandwidth`.  bench.py measures the device-HBM roofline offline
with a big triad; for in-engine attribution we need something cheap
enough to run lazily inside a session, so `measured_gbs()` times a
single ~64 MiB torch triad on the engine's device once per process and
device and caches it.  The
per-query figure is then

    roofline_fraction = (scan_bytes / measured_gbs) / device_wall_s

i.e. what fraction of the query's device wall the pure memory-stream
floor explains.  1.0 = the query runs at the bandwidth roofline; the
Q3/Q5 fusion gap shows up as fractions ≪ 1 (host round trips between
operators dominating the wall).  Clamped to [0, 1] — timer jitter on
sub-millisecond walls can push the raw ratio over 1."""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_GBS: dict = {}            # device string → sustained stream GB/s
_OVERRIDE: float = 0.0     # set_measured_gbs(): one figure for all devices


def measured_gbs(device) -> float:
    """Sustained stream bandwidth (GB/s) of `device`, measured once per
    process and device with a ~64 MiB float32 torch triad and cached.
    Returns 0.0 when the measurement fails (callers treat 0 as
    'unknown')."""
    if _OVERRIDE:
        return _OVERRIDE
    key = str(device)
    if _GBS.get(key):
        return _GBS[key]
    with _LOCK:
        if not _GBS.get(key):
            try:
                _GBS[key] = _measure(device)
            except (RuntimeError, ValueError):
                _GBS[key] = 0.0
    return _GBS[key]


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _measure(device) -> float:
    import time

    import torch

    n = 16 * 1024 * 1024                      # 64 MiB per operand
    x = torch.ones((n,), dtype=torch.float32, device=device)
    y = torch.full((n,), 2.0, dtype=torch.float32, device=device)
    out = torch.empty_like(x)

    def triad():
        torch.add(x, y, alpha=0.5, out=out)

    triad()                                   # warm up outside the timing
    _sync(device)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        triad()
    _sync(device)
    dt = time.perf_counter() - t0
    if dt <= 0.0:
        return 0.0
    moved = 3.0 * 4.0 * n * reps              # read a, read b, write out
    return moved / dt / 1e9


def set_measured_gbs(gbs: float) -> None:
    """Override the cached bandwidth (bench.py injects its own big-triad
    measurement so bench roofline fractions use the same denominator as
    its roofline section; tests inject a constant)."""
    global _OVERRIDE
    with _LOCK:
        _OVERRIDE = float(gbs)


def fraction(scan_bytes: int, device_wall_s: float, *, device,
             gbs: float = None) -> float:
    """Roofline fraction for one statement: stream-floor seconds over
    actual device wall, clamped to [0, 1].  0.0 when unmeasurable (no
    bytes, no wall, or no bandwidth figure)."""
    if gbs is None:
        gbs = measured_gbs(device)
    if scan_bytes <= 0 or device_wall_s <= 0.0 or gbs <= 0.0:
        return 0.0
    floor_s = scan_bytes / (gbs * 1e9)
    return max(0.0, min(1.0, floor_s / device_wall_s))


def effective_fraction(logical_bytes: int, device_wall_s: float, *,
                       device, gbs: float = None) -> float:
    """Roofline fraction against LOGICAL (uncompressed-equivalent)
    bytes. Deliberately NOT clamped above 1: a compressed scan that
    delivers logical bytes faster than the raw stream floor shows up as
    >1x effective bandwidth — that's the win, not a measurement error.
    `fraction()` (physical bytes actually streamed) stays the honest
    hardware-utilization figure; this one is the workload-throughput
    figure. 0.0 when unmeasurable."""
    if gbs is None:
        gbs = measured_gbs(device)
    if logical_bytes <= 0 or device_wall_s <= 0.0 or gbs <= 0.0:
        return 0.0
    floor_s = logical_bytes / (gbs * 1e9)
    return max(0.0, floor_s / device_wall_s)


__all__ = ["measured_gbs", "set_measured_gbs", "fraction",
           "effective_fraction"]
