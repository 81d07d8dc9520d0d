"""Shared fixtures of the benchmark's CPU tests: the harness run at a
small size on the CPU (the port's plain kernels), so that every test
drives the real encoder, the real window and the real check."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "superfast-pan-s32": {"config": {"width": 128, "height": 96},
                          "traffic": {"streams": 2, "ring": 4}},
    "faster-split-s16": {"config": {"width": 128, "height": 96},
                         "traffic": {"streams": 2, "ring": 4,
                                     "offset_px": [0, 8]}},
}


def small(cell: str, **workload) -> dict:
    """The cell's overrides for a CPU run: 128x96, 2 streams, a ring of 4
    frames, 3 sampled P frames."""
    o = {k: dict(v) for k, v in SMALL[cell].items()}
    o["workload"] = {"sample_p_frames": 3, "trace_profile_slots": 2,
                     "trace_stage_slots": 2, **workload}
    return o


@pytest.fixture
def run_small():
    """run_small(cell, seed, **kw) -> (result, log lines) of a harness run
    on the CPU at the small size, with a 0.6 s window."""
    import torch
    torch.set_num_threads(2)
    from portbench import harness

    def go(cell, seed=2**33 + 11, trace=False, control=False, seconds=0.6):
        lines = []
        r = harness.run(cell, seed, seconds, trace, device="cpu",
                        control=control, overrides=small(cell),
                        log=lines.append)
        return r, lines
    return go
