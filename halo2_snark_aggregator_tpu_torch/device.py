"""Device resolution for the port's entry points.

The port runs its kernels on CUDA, and a run that asks for CUDA never
carries on on the CPU: `cuda_device` raises when no card is present. The
CPU is used only when a caller passes it explicitly (the CPU tests, where
every kernel wrapper runs its plain twin).
"""

from __future__ import annotations

import time

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device `index`; raises when CUDA is unavailable."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; the port does not fall back to the CPU")
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {index}")
    return torch.device("cuda", index)


def resolve(device) -> torch.device:
    """An explicit device: "cuda"/"cuda:N" must exist, "cpu" selects the
    plain twins."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return cuda_device(dev.index or 0)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    """Start a new peak-memory window on `device` (nothing off the card)."""
    if device.type == "cuda":
        torch.cuda.init()  # the allocator's statistics need a context
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int | None:
    """The most bytes allocated on `device` since the last `reset_peak`
    (None off the card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)


def profile_device(fn, device: torch.device) -> dict:
    """Run `fn` once under torch.profiler: the wall time, the device busy
    time (the sum of the device events' times: kernels, copies, fills) and
    its share, and the 12 kernels with the most device time. Only events on
    the device count: a torch op's host event also carries the device time
    of the kernels it launched, which would count them twice."""
    from torch.profiler import ProfilerActivity, profile

    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            continue
        dt = getattr(ev, "self_device_time_total", 0) or 0
        if dt > 0:
            by_kernel[ev.key] = (ev.count, dt / 1e6)
    busy = sum(t for _c, t in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "by_kernel": {k: {"count": c, "s": t} for k, (c, t) in top}}
