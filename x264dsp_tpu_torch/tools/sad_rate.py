"""The card's packed-byte SAD rate, and SASS opcode counts of kernels.

    python -m x264dsp_tpu_torch.tools.sad_rate

Builds the probe ``tools/sad_rate.cu`` with nvcc into ``build/kernels/``
and times its loop of ``vabsdiff4`` with accumulate (the four-byte SAD
of ``csrc/me_sad.cu``) with CUDA events: 8 CTAs of 256 threads per SM,
each thread 16 independent sums x 4096 steps. Prints the card's name and
power limit, the rate in packed sums per second beside the instruction's
peak (``PEAK_SUMS_S``) and the SASS of the loop body (``cuobjdump
-sass``: opcodes and instructions per sum), then one JSON line. The
operations bound of kernels K1 and K4 (``chip_smoke.py``,
``tools/kernel_ab.py``) is their packed sums at that peak; the measured
rate is what the instruction reaches.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from .. import _build

SRC = Path(__file__).resolve().parent / "sad_rate.cu"
SUMS_PER_STEP = 16          # NACC in sad_rate.cu
# VABSDIFF4.U8.ACC issues at the int32 rate: 132 SMs x 64 lanes x 1.98 GHz
# (H100 SXM data sheet)
PEAK_SUMS_S = 132 * 64 * 1.98e9

_fn = None


def _probe():
    global _fn
    if _fn is None:
        _fn = ctypes.CDLL(str(_build.compile_source(SRC))).x264t_sad_rate
        _fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
        _fn.restype = ctypes.c_int
    return _fn


def rate() -> float:
    """Packed sums per second of the probe on CUDA device 0."""
    import torch
    reps, iters, threads = 5, 4096, 256
    fn = _probe()
    dev = torch.device("cuda")
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        _build.check(fn(out.data_ptr(), blocks, threads, iters, stream),
                     "x264t_sad_rate")
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    sums = blocks * threads * iters * SUMS_PER_STEP * reps
    return sums / (start.elapsed_time(end) * 1e-3)


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass(lib: Path) -> dict:
    """{function name: [(address, instruction text), ...]} from
    ``cuobjdump -sass`` of a built library."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib}:\n{r.stderr}")
    funcs, cur = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(text: str) -> str:
    """The instruction's opcode with its modifiers, predicate dropped."""
    toks = text.split()
    if toks and toks[0].startswith("@"):
        toks = toks[1:]
    return toks[0] if toks else ""


def loop_body(insns: list) -> list:
    """The instructions of the largest loop (a backward branch to a
    lower address, inclusive), or [] when there is none."""
    best = []
    for addr, text in insns:
        if not opcode(text).startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr:
            body = [(a, t) for a, t in insns if target <= a <= addr]
            if len(body) > len(best):
                best = body
    return best


def histogram(insns: list) -> dict:
    c = collections.Counter(opcode(t) for _, t in insns)
    return dict(c.most_common())


def function_named(funcs: dict, part: str) -> list:
    hits = [v for k, v in funcs.items() if part in k]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} SASS functions match {part!r}")
    return hits[0]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    body = loop_body(function_named(sass(_build.compile_source(SRC)),
                                    "sad_rate_kernel"))
    r = rate()
    rec = {"card": smi, "sums_per_s": r, "peak_sums_per_s": PEAK_SUMS_S,
           "loop_sass": histogram(body),
           "sass_per_sum": len(body) / SUMS_PER_STEP}
    print(f"vabsdiff4 with accumulate: {r / 1e12:.3f} T packed sums/s "
          f"({r / PEAK_SUMS_S:.3f} of the {PEAK_SUMS_S / 1e12:.3f} T peak); "
          f"loop {len(body)} SASS for {SUMS_PER_STEP} sums: "
          f"{histogram(body)}")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
