"""The window arithmetic on a fake encoder and a fake clock: a frame
counts once its NALs are back, the drain falls inside the window, and
slot_ms_p90 is taken over every slot; the check's samples take each
stream once before any stream twice."""

import random
from types import SimpleNamespace

import pytest

from portbench import catalog
from portbench.harness import closed_loop, sample_streams


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def run_fake(seconds, call_s, S=4):
    clock = FakeClock()
    handed = []

    def encode(j):
        clock.t += call_s
        if j is None:
            return [["nal"]] * S
        handed.append(j)
        return None if len(handed) == 1 else [["nal"]] * S

    done = []
    window_s, last, call_ms = closed_loop(
        encode, 2, seconds, lambda j: None,
        lambda j, out, th, tb: done.append((j, len(out), th, tb)),
        clock=clock)
    return window_s, last, call_ms, done, handed


def test_frames_count_once_returned_and_drain_inside():
    window_s, last, call_ms, done, handed = run_fake(1.0, 0.25)
    # hand-overs at 0.25, 0.5, 0.75, 1.0: the slot back at 1.0 completes
    # the window; the drain returns the last slot at 1.25
    assert handed == [2, 3, 4, 5]
    assert [d[0] for d in done] == [2, 3, 4, 5]
    assert window_s == 1.25
    assert last == 5
    assert len(call_ms) == 4
    r = SimpleNamespace(frames_done=4 * len(done), window_s=window_s,
                        slot_ms=[1e3 * (tb - th) for _, _, th, tb in done])
    assert catalog.metric("fps").read(r) == 16 / 1.25


def test_slot_latency_spans_two_calls_and_p90_over_all_slots():
    _, _, _, done, _ = run_fake(2.0, 0.1)
    ms = [round(1e3 * (tb - th), 6) for _, _, th, tb in done]
    # a slot's NALs come back at the end of the next call
    assert all(m == 200.0 for m in ms)
    r = SimpleNamespace(slot_ms=list(range(1, 101)))
    assert abs(catalog.metric("slot_ms_p90").read(r) - 90.1) < 1e-9
    assert catalog.metric("slot_ms_p90").read(
        SimpleNamespace(slot_ms=[5.0])) is None


@pytest.mark.parametrize("S,k", [(32, 21), (16, 13), (2, 4), (5, 5)])
def test_sampled_streams_differ_while_they_last(S, k):
    got = sample_streams(random.Random(2**33 + S), S, k)
    assert len(got) == k and set(got) <= set(range(S))
    assert len(set(got)) == min(k, S)
    assert len(set(got[:S])) == min(k, S)
