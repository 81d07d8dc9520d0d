"""90th percentile of slot latency over every slot of the window: from
the call that hands over a slot's S frames to the return of the call
that gives back its NALs; host clock. The slot count is printed on
standard error."""

import statistics


def read(r):
    if len(r.slot_ms) < 2:
        return None
    return statistics.quantiles(r.slot_ms, n=10, method="inclusive")[-1]
