"""Median over the traced P slots of the StageClock stages `deblock` and
`ref_planes` together (the deblocking filter and the next reference
planes), in ms."""

import statistics


def read(r):
    if not r.stages:
        return None
    return 1e3 * statistics.median(t["deblock"] + t["ref_planes"]
                                   for t in r.stages)
