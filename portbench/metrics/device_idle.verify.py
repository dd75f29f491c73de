"""device_idle.verify: the share of the profiled part of the traced window in
which no kernel, copy or fill ran on the card (the union of the device's
intervals in the torch.profiler trace)."""


def read(r):
    t = r.get("trace")
    if r.get("entry") != "verify" or t is None or t.window_s <= 0:
        return None
    return t.idle_pct
