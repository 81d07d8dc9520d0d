"""Median host time of one BatchEncoder.encode_batch call in the window
(the harness's span around each call); layer: pipeline."""

import statistics


def read(r):
    return statistics.median(r.call_ms) if r.call_ms else None
