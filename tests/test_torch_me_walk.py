"""The port's DIA / HEX full-pel walk (ops/me_walk.py) on the CPU, JAX-free.

pattern_walk_plain walks every MB in lockstep (the JAX package's
_pattern_walk); the CUDA kernel csrc/me_walk.cu walks each MB on its own
thread. The per-MB sequential walk of tests/torch_walk.py is the kernel's
loop in plain Python: it extends the JAX package's serial oracle
(tests/test_me_methods.py::_serial_walk) with the MVP bias, the neighbour
candidates, (0, 0), the legal ranges and the median MVP. The lockstep
walk must equal it on every MB; tests/test_torch_gpu.py holds the kernel
to the lockstep walk on the card.
"""

import pytest
import torch

import x264dsp_tpu_torch as xtt
from x264dsp_tpu_torch import params as P
from x264dsp_tpu_torch.ops import me_walk as ME
from torch_walk import serial_walk, walk_case


@pytest.mark.parametrize("R", [4, 16])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("later", [False, True])
@pytest.mark.parametrize("lanes", [True, False])
@pytest.mark.parametrize("method", [P.ME_DIA, P.ME_HEX])
def test_lockstep_walk_matches_serial_walk(method, lanes, later, cut, R):
    """Walk 1 (zero MVP, no candidates) and a later walk (median MVP and
    four candidates from a field reaching 2R) on both surface layouts,
    with the frame's legal range or one drawn per row and column: the
    best point, its cost, the MVP and the count of surface reads equal
    the per-MB sequential walk's."""
    case = walk_case(7 * R + 2 * lanes + later + 11 * cut, 2, 5, 4, R, lanes,
                     later, cut)
    *got, reads = ME.pattern_walk_plain(*case, method, count_reads=True)
    *want, want_reads = serial_walk(*case, method)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g, w)
    assert reads == want_reads


def test_walks_leave_the_origin_and_reach_the_cap():
    """The drawn surfaces make walks that move and walks that stop early:
    some MB of the DIA walk ends R diamonds from the start, and some
    never leaves it."""
    R = 4
    surf16, lanes, lam, bounds, prev, _ = walk_case(3, 2, 5, 4, R, True,
                                                    False, False)
    best, _, _ = ME.pattern_walk(surf16, lanes, lam, bounds, prev, R,
                                 P.ME_DIA)
    dist = best.abs().sum(-1)
    assert int(dist.max()) == R and int(dist.min()) == 0


def test_cpu_walk_launches_no_kernel():
    """A CPU tensor takes the plain walk: the pattern_walk counter, one of
    kernel_launches(), stays 0 through walk 1 and two later walks."""
    xtt.reset_kernel_launches()
    case = list(walk_case(5, 1, 3, 2, 4, False, False, True))
    for _ in range(3):
        best, cost, mvp = ME.pattern_walk(*case, P.ME_HEX)
        case[4] = best
    assert xtt.kernel_launches()["pattern_walk"] == 0
    assert best.shape == (1, 2, 3, 2) and cost.shape == (1, 2, 3)
