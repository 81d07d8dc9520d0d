"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1> [--control 1]

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and checks: each
compared number beside its limit); the last lines of standard error
repeat the checks. Exits non-zero, with no result, without enough CUDA
devices for the cell or when a module of JAX or of the JAX package was
loaded. --control 1 judges the reference decoder's own pictures at 7-bit
precision in place of the encoder's (the control, which has to come out
not correct).

A run is one process whose host thread pools (PyTorch's intra-op and
inter-op pools, OpenMP, MKL) are fixed at THREADS before torch is
imported, so its pace depends on no thread count of the machine.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

THREADS = 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    from portbench import catalog, harness
    cell = catalog.cell(a.workload)
    import torch
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                         start=START, control=bool(a.control), log=log)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
