"""Median over the traced P slots of the BatchEncoder's StageClock
stage `encode` (it synchronises the device at each stage), in ms."""

import statistics


def read(r):
    if not r.stages:
        return None
    return 1e3 * statistics.median(t["encode"] for t in r.stages)
