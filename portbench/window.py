"""The measured window: a closed loop of calls and its arithmetic.

Calls run back to back from the window's start. The window closes at the
end of the first call that ends `seconds` or more after the start, so it
holds only whole calls and every call that started in it. A rate is all
the work of the window over all of its time; a percentile is taken over
every call of the window, by nearest rank.
"""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Window:
    start: float                 # perf_counter at the window's start
    ends: list                   # perf_counter at each call's end
    durations: list              # each call's own seconds
    outputs: list                # what each call returned

    @property
    def calls(self) -> int:
        return len(self.ends)

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.start


def closed_loop(call, items, seconds: float, clock=time.perf_counter) -> Window:
    """Run `call(item)` for item in `items` back to back until one ends at
    least `seconds` after the start. `items` must not run out first."""
    it = iter(items)
    start = clock()
    ends, durs, outs = [], [], []
    while True:
        t0 = clock()
        outs.append(call(next(it)))
        t1 = clock()
        ends.append(t1)
        durs.append(t1 - t0)
        if t1 - start >= seconds:
            return Window(start, ends, durs, outs)


def rate(work: float, window: Window) -> float:
    """Work per second over the whole window."""
    return work / window.seconds


def per_call(window: Window) -> float:
    """Seconds of window per call."""
    return window.seconds / window.calls


def percentile(values, q: float) -> tuple[float, int]:
    """(the q-th percentile by nearest rank, the number of samples)."""
    if not values:
        raise ValueError("no samples")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1], len(xs)
