"""Sweep the compile-time shape constants of kernels K2b and K6 on one GPU.

    python -m x264dsp_tpu_torch.tools.kernel_sweep [--reps 50]

Builds variants of ``csrc/windows.cu`` (K2b, chroma MC windows: the MBs
per column group ``G``, which K2a shares, and the CTA count that the
band split aims at, ``CTAS_C``) and of ``csrc/deblock.cu`` (K6, the
region filter chain: the warps, one MB each, per CTA ``RW``), one nvcc
per variant, all started together, into ``build/kernels/``. Each variant
runs at the main path's 1080p 8-stream shapes (K2b on padded chroma
planes; K6 on the longest diagonal's 480 regions with P-type lanes, as
``tools/kernel_ab.py`` builds them), must equal the plain version, and
is timed by its device time per launch (torch.profiler, as
``kernel_ab.device_ms``). Prints the card's name and power limit, one
line per variant (the committed constants marked) and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import deblock as DB
from ..ops import mc as MC
from ..ops import mcgather as MG
from ..ops.tables import CHROMA_QP_TABLE
from .kernel_ab import H, S, W, device_ms

K2B = [{"G": g, "CTAS_C": c} for g in (4, 8, 16) for c in (132, 264, 528,
                                                            1056)]
K6 = [{"RW": rw} for rw in (1, 2, 4, 8)]


def variant(name: str, consts: dict):
    """Start nvcc on csrc/`name` with the given `constexpr int` values:
    (source path, build job or None)."""
    text = (_build.SRC_DIR / name).read_text()
    for k, v in consts.items():
        text, n = re.subn(rf"constexpr int {k} = [^;]+;",
                          f"constexpr int {k} = {v};", text)
        if n != 1:
            sys.exit(f"{name}: no single constexpr {k}")
    tag = "_".join(f"{k}{v}" for k, v in consts.items())
    src = _build.BUILD_DIR / "sweep" / f"{name[:-3]}_{tag}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return src, _build._start(src)


def load(src, fn_name: str, argtypes):
    fn = getattr(ctypes.CDLL(str(_build.lib_path(src))), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def committed(name: str, consts: dict) -> bool:
    text = (_build.SRC_DIR / name).read_text()
    return all(re.search(rf"constexpr int {k} = {v};", text)
               for k, v in consts.items())


def k6_inputs(dev, rng):
    """The longest diagonal's regions and P-type lanes at 1080p, S = 8."""
    mb_w, mb_h = W // 16, H // 16

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=dev)
    y = t(rng.integers(0, 256, (S, H, W)))
    u, v = (t(rng.integers(0, 256, (S, H // 2, W // 2))) for _ in range(2))
    grid = (S, mb_h, mb_w)
    qp = rng.integers(20, 41, grid)
    luma_l, chroma_l = DB.wave_lanes(
        t(rng.integers(0, 3, grid + (2, 4, 4))), t(np.zeros(grid)),
        t(rng.random(grid) < 0.2), t(qp), t(CHROMA_QP_TABLE[qp]), 0, 0,
        mb_w, mb_h)
    ys, xs = (torch.as_tensor(a, device=dev)
              for a in DB.diag_slots(mb_w, mb_h))
    d = int((ys >= 0).sum(1).argmax())
    k = int((ys[d] >= 0).sum())
    F = torch.nn.functional
    ry, rx = DB.region_index(ys[d, :k], xs[d, :k], 16, 20, dev)
    cy, cx = DB.region_index(ys[d, :k], xs[d, :k], 8, 12, dev)
    regy = F.pad(y, (4, 4, 4, 4))[:, ry, rx].reshape(S * k, 20, 20)
    regc = F.pad(torch.stack([u, v], 1), (4, 4, 4, 4))[:, :, cy, cx] \
        .transpose(1, 2).reshape(2 * S * k, 12, 12).contiguous()
    ly = [x[:, d, :k].reshape(S * k, -1).contiguous() for x in luma_l]
    lc = [x[:, d, :2 * k].reshape(2 * S * k, -1).contiguous()
          for x in chroma_l]
    return (regy, regc, ly[0], lc[0], ly[1], ly[2], lc[1], lc[2], ly[3],
            ly[4], lc[3], lc[4])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    jobs = [("windows.cu", c, *variant("windows.cu", c)) for c in K2B] \
        + [("deblock.cu", c, *variant("deblock.cu", c)) for c in K6]
    errors = [err for _, _, src, job in jobs
              if job is not None and (err := _build._finish(src, job))]
    if errors:
        sys.exit("\n".join(errors))
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    mb_w, mb_h = W // 16, H // 16
    refc = MC.pad_chroma(torch.as_tensor(
        rng.integers(0, 256, (S, H // 2, W // 2)), dtype=torch.uint8,
        device=dev)).contiguous()
    want_c = MG.chroma_windows_plain(refc, mb_w, mb_h)
    regs = k6_inputs(dev, rng)
    want_r = DB.filter_regions_plain(*regs)
    P, I = ctypes.c_void_p, ctypes.c_int
    rec = []
    for name, consts, src, _ in jobs:
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "windows.cu":
            fn = load(src, "x264t_chroma_windows", [P, P] + [I] * 7 + [P])
            out = (torch.empty_like(want_c),)
            _, Hc, Wc = refc.shape
            call_args = (refc.data_ptr(), out[0].data_ptr(), S, mb_h, mb_w,
                         Hc, Wc, MG.M_CHROMA, MC.PAD_MC // 2, stream)
            kernel, want = "chroma_windows_kernel", (want_c,)
        else:
            fn = load(src, "x264t_filter_regions", [P] * 14 + [I, P])
            out = tuple(torch.empty_like(x) for x in want_r)
            call_args = (*(x.data_ptr() for x in out),
                         *(x.data_ptr() for x in regs), regs[0].shape[0],
                         stream)
            kernel, want = "filter_regions_kernel", want_r

        def call(fn=fn, a=call_args):
            _build.check(fn(*a), "variant")
        call()
        torch.cuda.synchronize()
        exact = all(torch.equal(o, w) for o, w in zip(out, want))
        ms = device_ms(call, kernel, args.reps)
        mark = committed(name, consts)
        print(f"{name} {consts}{' (committed)' if mark else ''}: "
              f"exact={exact} device {ms:.5f} ms", flush=True)
        rec.append(dict(source=name, consts=consts, committed=mark,
                        exact=exact, device_ms=ms))
        if not exact:
            sys.exit(f"{name} {consts} disagrees with its plain version")
    print(json.dumps({"card": smi, "variants": rec}))


if __name__ == "__main__":
    main()
