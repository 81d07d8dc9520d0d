"""The frame generator: the same frames for the same seed, others for
another seed, every seed the same parts of the mix, and the walk."""

import json

import pytest
import torch

from portbench import catalog
from portbench.traffic import frames as F


@pytest.mark.parametrize("traffic,extra", [("pan-s32", {}),
                                           ("split-s16",
                                            {"offset_px": [0, 8]})])
def test_same_seed_same_frames(traffic, extra):
    tr = dict(catalog.traffic(traffic), streams=3, ring=3, **extra)
    a = F.make_ring(tr, 64, 48, 2**40 + 3, "cpu")
    b = F.make_ring(tr, 64, 48, 2**40 + 3, "cpu")
    c = F.make_ring(tr, 64, 48, 2**40 + 4, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3, 3, 48, 64) and a[1].shape == (3, 3, 24, 32)
    assert a[0].dtype == torch.uint8


def test_seeds_deal_the_same_parts():
    """Two seeds give the split scene's streams the same set of frames
    up to the noise: with the noise off, the same frames in another
    stream order."""
    tr = dict(catalog.traffic("split-s16"), streams=4, ring=2,
              offset_px=[0, 8])
    a = F._split(tr, 4, 64, 48, 5, "cpu")[1]
    b = F._split(tr, 4, 64, 48, 6, "cpu")[1]
    key = lambda t: sorted(t[0, s].float().sum().item()  # noqa: E731
                           for s in range(t.shape[1]))
    assert key(a) == key(b)


def test_walk_reverses_without_jumps():
    seq = [F.walk(i, 4) for i in range(14)]
    assert seq == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1, 0, 1]
    assert all(abs(a - b) == 1 for a, b in zip(seq, seq[1:]))


def test_traffic_files_name_their_generator():
    for cell in catalog.benchmark()["workloads"]:
        tr = catalog.traffic(cell["traffic"])
        gen = catalog.generator(tr["generator"])
        assert tr["scene"] in gen.SCENES
        assert json.dumps(tr)
