"""Share of the traced P slots' wall in which no operation ran on the
device: 100 (1 - busy / window), busy the union of the profiler's
device activity."""


def read(r):
    if r.trace is None or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
