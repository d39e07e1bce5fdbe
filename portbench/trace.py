"""Reading a profiled stretch of matrices: device intervals, idle gaps and
what the host was doing in them.

The matrices run under ``torch.profiler`` (CPU and CUDA activities), each
inside a ``record_function`` span named ``MARK``; a thread samples the
Python stacks meanwhile (``HostSampler``).  Device intervals are the
profiler's device events: kernels, copies and fills (the span's own
annotation on the device's timeline is not one).  An idle gap is a
stretch of a matrix's span with no device interval; its time goes to
the host samples taken in it, each named after the innermost frame in
the program's package, as ``module/path.py:function``, of a thread that
is not waiting
(the program drives each card from a worker thread of its own, while the
calling thread waits for them).
"""

from __future__ import annotations

import bisect
import os
import sys
import threading
import time

import torch

MARK = "portbench.matrix"


# where a thread that waits for another one sits
_WAITS = ("threading.py", "queue.py", "_base.py", "thread.py")


class HostSampler(threading.Thread):
    """Samples every thread's stack every ``period`` seconds:
    (perf_counter in microseconds, label of the working thread), the
    thread ``main`` first where it is not waiting."""

    def __init__(self, main: int, package_dir: str, period: float = 0.001):
        super().__init__(daemon=True)
        self.main = main
        self.package_dir = package_dir + os.sep
        self.period = period
        self.samples: list[tuple[float, str]] = []
        self._stop_event = threading.Event()

    def label(self, frame) -> str | None:
        """None for a waiting thread; else its innermost frame in the
        package, or its innermost frame."""
        code = frame.f_code
        if os.path.basename(code.co_filename) in _WAITS:
            return None
        innermost = code
        while frame is not None:
            path = frame.f_code.co_filename
            if path.startswith(self.package_dir):
                rel = path[len(self.package_dir):]
                return f"{rel}:{frame.f_code.co_name}"
            frame = frame.f_back
        return f"{os.path.basename(innermost.co_filename)}:{innermost.co_name}"

    def run(self) -> None:
        me = threading.get_ident()
        while not self._stop_event.is_set():
            frames = sys._current_frames()
            order = [self.main] + [t for t in frames
                                   if t not in (me, self.main)]
            for ident in order:
                frame = frames.get(ident)
                label = self.label(frame) if frame is not None else None
                if label is not None:
                    self.samples.append((time.perf_counter() * 1e6, label))
                    break
            del frames, frame
            time.sleep(self.period)

    def stop(self) -> None:
        self._stop_event.set()
        self.join()


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _busy_and_gaps(spans, device):
    """The union of the device intervals (sorted by start) inside the
    spans, in microseconds, and the stretches of the spans with none."""
    busy_us, gaps = 0.0, []
    k = 0
    for s0, s1 in spans:
        cursor = s0
        while k < len(device) and device[k][2] <= s0:
            k += 1
        j = k
        while j < len(device) and device[j][1] < s1:
            t0, t1 = max(device[j][1], cursor), min(device[j][2], s1)
            if t1 > cursor:
                if t0 > cursor:
                    gaps.append((cursor, t0))
                busy_us += t1 - max(t0, cursor)
                cursor = t1
            j += 1
        if s1 > cursor:
            gaps.append((cursor, s1))
    return busy_us, gaps


def read_profile(prof, host_starts_us: list[float],
                 samples: list[tuple[float, str]], cards: int = 0) -> dict:
    """What the profiled matrices show.  ``host_starts_us`` are the
    perf_counter times (microseconds) at which each marked matrix began,
    in order; the first aligns the samples with the profiler's clock.
    ``busy_s`` is the union over all cards; ``busy_s_by_card`` each
    card's own, for cards 0 to ``cards`` - 1 and any other the trace
    names."""
    spans, device = [], []
    for e in prof.events():
        if _is_device(e):
            if e.name != MARK and e.time_range.end > e.time_range.start:
                device.append((e.name, e.time_range.start, e.time_range.end,
                               e.device_index))
        elif e.name == MARK:
            spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    device.sort(key=lambda d: d[1])
    kernels: dict[str, list[float]] = {}
    for name, t0, t1, _ in device:
        tot = kernels.setdefault(name, [0.0, 0])
        tot[0] += t1 - t0
        tot[1] += 1
    busy_us, gaps = _busy_and_gaps(spans, device)
    by_card = {card: _busy_and_gaps(
        spans, [d for d in device if d[3] == card])[0] / 1e6
        for card in sorted(set(range(cards)) | {d[3] for d in device})}
    offset = (host_starts_us[0] - spans[0][0]) if spans and host_starts_us \
        else 0.0
    # a gap's time goes to the samples inside it, in equal parts; a gap
    # with none inside goes to the sample nearest its middle
    idle: dict[str, float] = {}
    times = [t for t, _ in samples]
    for g0, g1 in gaps:
        lo = bisect.bisect_left(times, g0 + offset)
        hi = bisect.bisect_right(times, g1 + offset)
        if hi > lo:
            share = (g1 - g0) / 1e6 / (hi - lo)
            for _, label in samples[lo:hi]:
                idle[label] = idle.get(label, 0.0) + share
            continue
        label = "no host sample"
        if samples:
            mid = (g0 + g1) / 2 + offset
            near = [c for c in (lo - 1, lo) if 0 <= c < len(samples)]
            label = samples[min(near, key=lambda c: abs(times[c] - mid))][1]
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    wall_us = sum(s1 - s0 for s0, s1 in spans)
    return {
        "matrices": len(spans),
        "wall_s": wall_us / 1e6,
        "busy_s": busy_us / 1e6,
        "busy_s_by_card": by_card,
        "kernels": {name: (us / 1e6, int(c))
                    for name, (us, c) in kernels.items()},
        "idle_by_host": idle,
    }
