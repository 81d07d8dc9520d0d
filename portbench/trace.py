"""Reduction of a torch.profiler trace of a few P slots: the device's
busy time (the union of its activity intervals), its operations, each
kernel's time and the longest idle gaps with what the host was doing
(the innermost host operation over the gap's middle). The arithmetic of
x264dsp_tpu_torch/tools/profile_slot.py, with a union in place of its
sum so that overlapping activity is counted once."""

from __future__ import annotations


def reduce(events, window_s: float, slots: int) -> dict:
    """events: profiler FunctionEvents. Returns the trace record the
    metric readers take."""
    from torch.autograd import DeviceType
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    kernels, counts = {}, {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e6
        counts[e.name] = counts.get(e.name, 0) + 1
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for s, e in longest:
        mid = (s + e) / 2
        over = [h for h in host
                if h.time_range.start <= mid <= h.time_range.end]
        name = min(over, key=lambda h: h.time_range.elapsed_us()).name \
            if over else "(host code outside any profiled operation)"
        idle.append([name, (e - s) / 1e6])
    # device operation names cut to 160 characters (C++ templates)
    top = [(n[:160], t) for n, t in
           sorted(kernels.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": window_s, "busy_s": busy_us / 1e6, "slots": slots,
            "device_ops": len(dev), "kernels": kernels,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": idle}}
