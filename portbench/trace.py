"""Reading a torch.profiler trace of part of a traced window.

The profiler records host and device activity; only device activity
(kernels, copies, fills) counts as busy. Busy time is the union of the
device intervals inside the profiled part, so overlapping work counts
once; the idle share is the rest. Each idle gap is named by the innermost
host span that was open at its middle (spans are (name, start_ns, end_ns)
on the wall clock, `time.time_ns()`, the clock the profiler's events
use). Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
import re

@dataclasses.dataclass
class Summary:
    window_s: float              # the profiled part's length
    busy_s: float                # union of device intervals in it
    by_kernel: dict              # short name -> (launches, device seconds)
    idle_by_span: dict           # host span name -> idle seconds

    @property
    def idle_pct(self) -> float:
        return 100.0 * (self.window_s - self.busy_s) / self.window_s

    def kernel(self, pattern: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches."""
        rx = re.compile(pattern)
        n, s = 0, 0.0
        for name, (c, t) in self.by_kernel.items():
            if rx.search(name):
                n, s = n + c, s + t
        return n, s


def short_name(name: str) -> str:
    """A kernel's name without its argument list or template arguments."""
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:120] or name[:120]


def start():
    """A started profiler of the device's activity (no host events)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> None:
    import torch

    torch.cuda.synchronize()
    prof.stop()


def _on_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA and not e.is_user_annotation()


def device_events(prof) -> list:
    """[(start_ns, end_ns, name)] of the device's kernels, copies and fills:
    the trace's events on the CUDA device that are no annotation."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if _on_device(e):
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), e.name()))
    return out


def union(intervals, lo: int, hi: int) -> list:
    """Merged [start, end) intervals clipped to [lo, hi)."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, lo: int, hi: int) -> list:
    """The idle [start, end) intervals of [lo, hi) around merged `busy`."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans, t: int) -> str:
    """The name of the shortest host span that holds time t."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "between calls"


def summarize(events, spans, lo: int, hi: int) -> Summary:
    """Busy, idle and kernel time of [lo, hi) from `device_events` and host
    `spans`."""
    by_kernel: dict[str, list] = {}
    for s, e, name in events:
        if e <= lo or s >= hi:
            continue
        k = short_name(name)
        c = by_kernel.setdefault(k, [0, 0.0])
        c[0] += 1
        c[1] += (min(e, hi) - max(s, lo)) / 1e9
    busy = union([(s, e) for s, e, _ in events], lo, hi)
    idle: dict[str, float] = {}
    for s, e in gaps(busy, lo, hi):
        k = innermost(spans, (s + e) // 2)
        idle[k] = idle.get(k, 0.0) + (e - s) / 1e9
    return Summary(window_s=(hi - lo) / 1e9,
                   busy_s=sum(e - s for s, e in busy) / 1e9,
                   by_kernel={k: (c, t) for k, (c, t) in by_kernel.items()},
                   idle_by_span=idle)


def breakdown(summary: Summary) -> dict:
    """The ten device operations with the most time, and the host spans
    under which the device idled longest."""
    ops = sorted(summary.by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(summary.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, t] for k, (_c, t) in ops],
            "idle_gaps": [[k, t] for k, t in idle]}
