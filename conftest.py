"""How the repo's pytest runs are laid out (tests/ and portbench/tests/).

Loaded before tests/conftest.py. It sets each xdist worker's thread
budget, the order in which `--dist loadfile` hands out the files, the
files that tier-1 (`-m 'not slow'`) leaves out, and a per-test limit past
which a test's stacks are printed. Tier-1 runs
`python -m pytest tests/ -m 'not slow' -n 6 --dist loadfile`.
"""

import faulthandler
import os

# One thread budget per xdist worker: the cores split evenly over the
# workers (6 workers that each start torch with a thread per core slow a
# test of many small torch ops 30-70x). Set before torch loads, and in the
# workers only: the controller's environment reaches them, so a count it
# set would pass for one the user set. A count in the environment wins.
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _THREADS = max(1, os.cpu_count()
                   // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, str(_THREADS))
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    torch.set_num_interop_threads(int(os.environ["OMP_NUM_THREADS"]))

import pytest  # noqa: E402

# The test files of over 100 s, with their seconds: the mean junit time
# of the file in three tier-1 runs on an 8-core CPU host (test_denoise:
# one run). They are handed out longest first, and the files left out
# here follow in name order and fill the workers' tails; a file that
# passes 100 s joins the list. (loadfile's own order, most tests first,
# is turned off: it starts the long files of 2-7 tests last.)
FILE_SECONDS = {
    "test_syn_wire.py": 518,
    "test_denoise.py": 326,
    "test_torch_batch.py": 315,
    "test_torch_inter.py": 288,
    "test_torch_partitions.py": 283,
    "test_torch_batch_settings.py": 278,
    "test_torch_encoder.py": 237,
    "test_torch_ratecontrol.py": 231,
    "test_multiref.py": 200,
    "test_subme.py": 198,
    "test_torch_refs.py": 189,
    "test_lookahead.py": 186,
    "test_forced_types.py": 182,
    "test_aq.py": 181,
    "test_cabac.py": 177,
    "test_slices.py": 176,
    "test_row_vbv.py": 170,
    "test_hrd_filler.py": 163,
    "test_intra_skew.py": 161,
    "test_headers.py": 161,
    "test_torch_slices.py": 145,
    "test_ratecontrol.py": 139,
    "test_partitions.py": 115,
    "test_recovery.py": 115,
}

# The JAX package's own test files that tier-1 leaves out, longest first.
# Each imports nothing of the port, took over 300 s in a tier-1 run, and
# has port tests that hold the port to the JAX package on its setting.
# Seconds: the file in a tier-1 run on an 8-core CPU host, before and
# with the thread budget. Run them with: python -m pytest tests/ -m slow
SLOW_FILES = (
    # 552 s, 1009 s. Device CAVLC on the Encoder's path and the overflow
    # re-encode: test_torch_refs (byte for byte against the JAX Encoder).
    "test_device_entropy_path.py",
    # 474-718 s, 1192 s. Per-stream CRF and ABR in the BatchEncoder:
    # test_torch_batch_settings; CQP: test_torch_batch.
    "test_batch_v2.py",
    # 425 s, 447 s. The JVT lists: test_torch_refs; JVT and custom lists
    # in the quantisers and the Encoder's tables: test_torch_cqm.
    "test_cqm.py",
    # 411 s, 453 s. The device CAVLC packer on the same random syntax:
    # test_torch_cavlc_device (against the JAX packer and the writers).
    "test_cavlc_device.py",
)

# A test still running this many seconds after it began (set-up
# included) writes every thread's stack to the run's stderr, once, so a
# hang that cuts the run shows where it hung; it ends nothing. Half again
# the slowest test in tier-1 (377 s), rounded up to whole minutes: it
# fires for any test that starts in the first 870 s of the 1470 s that
# tier-1 is given.
TEST_LIMIT_S = 600
_STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    # fd 2 as it is now: during a test it is captured.
    config.stash[_STDERR] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    faulthandler.dump_traceback_later(TEST_LIMIT_S,
                                      file=item.config.stash[_STDERR])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(tryfirst=True)  # before -m 'not slow' deselects
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.path.name in SLOW_FILES:
            item.add_marker(pytest.mark.slow)
    items.sort(key=lambda item: -FILE_SECONDS.get(item.path.name, 0))
