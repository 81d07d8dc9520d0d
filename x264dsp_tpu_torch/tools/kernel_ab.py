"""Time the hand-written kernels of one checkout on one GPU, at the main
path's 1080p 8-stream shapes: K1 (16x16 SAD surface), K4 (8x8-quadrant
SAD surfaces), K3 (whole-frame deblock), K2a / K2b (luma / chroma MC
windows), K5a / K5b (wave deblock) and K6 (region filter chain):

    python x264dsp_tpu_torch/tools/kernel_ab.py --root DIR [--rate]
        [--ptxas] [--sass]

DIR is the root of a checkout of this repository (this one, or an
unpacked older commit): its ``x264dsp_tpu_torch`` package is imported and
its ``csrc/`` kernels are built into DIR/build/kernels. To compare two
commits, run the script once per checkout, in turns (A, B, B, A), inside
one call on one card. The script is run as a file, not as a module, so
that it imports DIR's package and not its own.

Prints the card's name and power limit, then one JSON line: mean ms per
call over CUDA events (after a warm-up; where a call's host side, the
wrapper's checks and the launch, takes longer than the kernel, this is
the host's time) and the kernel's own device ms per launch from
torch.profiler, for K1 and K4 (R = 16), for K3
on a P-type and an all-intra frame batch, for K2a and K2b, for K5a and
K5b on the lanes of both batches and for K6 on the longest diagonal of
the P-type batch (480 regions, gathered as chip_smoke.py gathers them);
K3's, K5a's and K5b's us per critical-path MB step (ms / (mb_w + 2 mb_h
- 2)), and K3's us per
MB on one MB row of the P-type batch (steps without handoffs) and on one
MB column (each step after a handoff from the row above); a digest of
each kernel's output, which must be equal across checkouts; bounds:
bytes over 3.35 TB/s for every kernel, and for K1 / K4 also their 4.55 G
packed sums at the instruction's peak (``sad_rate.PEAK_SUMS_S``, the
probe module beside this script). Where DIR's ``ops/me_sad`` has the
pixel-range check of the SAD dispatchers (``check_pixels``), also its
host wall per call on the 1080p inputs (it ends in a host sync), beside
that of the same test as ``torch._assert_async`` (no sync; enqueue wall,
and its device time). With --rate, also the packed-SAD rate that the
probe reaches on the card (its build needs ``_build.compile_source``, so
DIR must be a checkout that has it). With --ptxas, also the registers,
stack, shared memory and spills that ``nvcc -Xptxas -v`` reports for the
SAD, windows (K2a, K2b) and deblock (K3, K5a, K5b, K6) sources, and
the deblock kernels' registers, stack and spills in the JSON line; with
--sass, each SAD kernel's SASS opcode counts (``cuobjdump -sass``): the
whole function, its largest loop body and its instructions per packed
sum.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

W, H, S, R = 1920, 1088, 8, 16
HBM_BYTES_S = 3.35e12        # H100 SXM data sheet
# the row-pipeline deblock kernels (K3, K5a, K5b) and K6
DEBLOCK_KERNELS = ("deblock_kernel", "deblock_wave_luma_kernel",
                   "deblock_wave_chroma_kernel", "filter_regions_kernel")


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_cuda(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int, per_call: int = 1) -> float:
    """Mean device time per launch of the CUDA kernel named `kernel` over
    `reps` calls of fn (each launching it `per_call` times), from
    torch.profiler's CUDA activity: the kernel's
    own time, without the host time between launches that CUDA events
    over back-to-back calls include when a call's host side is the
    longer. The profiler may miss a launch at the start of its window,
    so the mean is over the launches it recorded (at least half); a
    window that recorded fewer (one has recorded none of ten 0.06 ms
    launches) is printed with its count and taken again, up to three
    windows."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pat = re.compile(rf"\b{kernel}\b")
    for window in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and pat.search(e.name)]
        if len(ev) > reps * per_call:
            break
        if len(ev) >= reps * per_call / 2:
            return sum(e.time_range.elapsed_us() for e in ev) / len(ev) / 1e3
        print(f"profiler window {window + 1} of 3 recorded {len(ev)} "
              f"launches of {kernel} in {reps} calls", flush=True)
    sys.exit(f"profiler: {len(ev)} launches of {kernel} in {reps} calls")


def ptxas(root: Path, build,
          names=("me_sad.cu", "deblock.cu", "windows.cu")) -> list:
    """`nvcc -Xptxas -v` on the SAD, windows and deblock sources (or
    `names`): the kernel lines (the SAD kernels' shared memory is dynamic:
    ptxas shows 0)."""
    out = []
    for name in names:
        obj = build.BUILD_DIR / f"ptxas_{name}.o"
        obj.parent.mkdir(parents=True, exist_ok=True)
        flags = [f for f in build.NVCC_FLAGS if f not in ("-shared",)]
        r = subprocess.run([build._nvcc(), *flags, "-Xptxas", "-v", "-c",
                            "-o", str(obj), str(build.SRC_DIR / name)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            sys.exit(f"nvcc failed on {name}:\n{r.stderr}")
        out += [f"{name}: {line.strip()}" for line in r.stderr.splitlines()
                if "Compiling entry" in line or "Function properties" in line
                or "registers" in line or "spill" in line]
    return out


def ptxas_usage(lines: list, kernels) -> dict:
    """Registers, stack frame and spill bytes of each named kernel, from
    ptxas's lines (as `ptxas` returns them): {kernel: {"registers": n,
    "stack": bytes, "spill_stores": bytes, "spill_loads": bytes}}."""
    import re
    out, cur = {}, None
    for line in lines:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = next((k for k in kernels
                        if f"{len(k)}{k}" in m.group(1)), None)
            continue
        if cur is None:
            continue
        rec = out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rec.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m[1])
    return out


def load_sad_rate():
    """The probe module beside this script, bound to DIR's package (it
    uses DIR's _build for nvcc and the build directory); the SASS helpers
    run on any checkout, the rate needs a _build with compile_source."""
    path = Path(__file__).resolve().with_name("sad_rate.py")
    spec = importlib.util.spec_from_file_location(
        "x264dsp_tpu_torch.tools.sad_rate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sad_sass(build, probe) -> dict:
    """Each SAD kernel's SASS: instruction count, opcode counts, its
    largest loop body and instructions per packed sum (the count of the
    packed-sum opcode; none in an int32 design)."""
    lib = build._build()["me_sad.cu"]
    funcs = probe.sass(lib)
    out = {}
    for name in ("sad_surface16_kernel", "sad_surfaces_8x8_kernel"):
        insns = probe.function_named(funcs, name)
        hist = probe.histogram(insns)
        body = probe.loop_body(insns)
        sums = sum(c for op, c in hist.items() if op.startswith("VABSDIFF4")
                   or op.startswith("VSAD"))
        out[name] = {"sass": len(insns), "opcodes": hist,
                     "loop_sass": len(body),
                     "loop_opcodes": probe.histogram(body),
                     "sass_per_sum": len(insns) / sums if sums else None}
    return out


def range_check(me_sad, t, rng, mb_w: int, mb_h: int, reps: int) -> dict:
    """The SAD dispatchers' pixel-range check on the main path's 1080p
    inputs (fenc and the R = 16 strips): host wall per call of
    check_pixels (aminmax of both, one host sync), and of the same test
    as torch._assert_async (enqueue only, no sync); and each one's CUDA
    event time per call (for check_pixels, whose every call syncs, that is
    its wall again; for the other, its device time)."""
    import time

    import torch
    fenc = t(rng.integers(0, 256, (S, H, W)))
    strips = t(rng.integers(0, 256, (S, mb_h, 16 + 2 * R, W + 2 * R)))

    def asserted():
        lo_hi = torch.stack([*torch.aminmax(fenc), *torch.aminmax(strips)])
        torch._assert_async((lo_hi[::2].min() >= 0)
                            & (lo_hi[1::2].max() <= 255))

    out = {}
    for name, fn in (("check_pixels", lambda: me_sad.check_pixels(
            fenc, strips)), ("assert_async", asserted)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[f"range_{name}_host_ms"] = \
            (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        out[f"range_{name}_events_ms"] = time_cuda(fn, reps)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import x264dsp_tpu_torch
    if Path(x264dsp_tpu_torch.__file__).resolve().parents[1] != root:
        sys.exit(f"imported {x264dsp_tpu_torch.__file__}, not {root}")
    from x264dsp_tpu_torch import _build
    from x264dsp_tpu_torch.ops import deblock as DB
    from x264dsp_tpu_torch.ops import mc as MC
    from x264dsp_tpu_torch.ops import mcgather as MG
    from x264dsp_tpu_torch.ops import me_sad
    from x264dsp_tpu_torch.ops.tables import CHROMA_QP_TABLE
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    _build.lib()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    mb_w, mb_h = W // 16, H // 16

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    recon = t(rng.integers(0, 256, (S, H, W)), torch.uint8)
    ref4 = MC.make_ref_planes(recon).contiguous()
    blocky = np.kron(rng.integers(0, 256, (S, mb_h * 4, mb_w * 4)),
                     np.ones((1, 4, 4), np.int64))
    y = t((blocky + rng.integers(-6, 7, (S, H, W))).clip(0, 255))
    cu = np.kron(rng.integers(0, 256, (S, mb_h * 2, mb_w * 2)),
                 np.ones((1, 4, 4), np.int64))
    u, v = t(cu), t(255 - cu)
    qp = rng.integers(20, 41, (S, mb_h, mb_w))
    grid = (S, mb_h, mb_w)
    p_args = (y, u, v, t(rng.integers(0, 3, grid + (2, 4, 4))),
              t(np.zeros(grid)), t(rng.random(grid) < 0.2), t(qp),
              t(CHROMA_QP_TABLE[qp]), 0, 0, mb_w, mb_h)
    i_args = (y, u, v, t(np.full(grid + (2, 4, 4), 3)), t(np.ones(grid)),
              t(np.zeros(grid)), t(qp), t(CHROMA_QP_TABLE[qp]), 0, 0, mb_w,
              mb_h)
    steps = mb_w + 2 * mb_h - 2
    rec = {"root": str(args.root), "card": smi, "shape": [S, H, W]}

    def timed(name: str, fn) -> float:
        """CUDA-event ms per call into rec[name_ms], the kernel's device
        ms (profiler) into rec[name_device_ms]; returns the former."""
        rec[f"{name}_ms"] = time_cuda(fn, args.reps)
        rec[f"{name}_device_ms"] = device_ms(
            fn, name.split("[")[0] + "_kernel", args.reps)
        return rec[f"{name}_ms"]

    # K1 / K4 at R = 16: random source pixels against the strips of recon
    fenc = t(rng.integers(0, 256, (S, H, W)))
    strips = me_sad.make_ref_strips(ref4[:, 0], MC.PAD_MC, mb_w, mb_h, R)
    n = 2 * R + 1
    probe = load_sad_rate()
    if args.rate:
        rec["sad_rate_sums_per_s"] = probe.rate()
    sums = S * H * W * n * n // 4
    in_bytes = (fenc.numel() + strips.numel()) * 4
    for name, fn, out_ints in (
            ("sad_surface16", me_sad.sad_cost_surface16_lanes_cuda,
             S * mb_h * mb_w * n * n),
            ("sad_surfaces_8x8", me_sad.sad_cost_surfaces_8x8_cuda,
             4 * S * mb_h * mb_w * n * n)):
        timed(name, lambda f=fn: f(fenc, strips, mb_w, mb_h, R))
        rec[f"{name}_digest"] = digest(fn(fenc, strips, mb_w, mb_h, R))
        rec[f"{name}_bound_bytes_ms"] = \
            (in_bytes + 4 * out_ints) / HBM_BYTES_S * 1e3
        rec[f"{name}_bound_ops_ms"] = sums / probe.PEAK_SUMS_S * 1e3
    del fenc, strips
    for tag, a in (("P", p_args), ("I", i_args)):
        ms = timed(f"deblock[{tag}]", lambda: DB.deblock_frame_cuda(*a))
        rec[f"deblock[{tag}]_us_per_step"] = 1e3 * ms / steps
        rec[f"deblock[{tag}]_digest"] = digest(*DB.deblock_frame_cuda(*a))
    # where K3's time goes: one MB row (mb_w steps, no handoff) and one MB
    # column (mb_h steps, each after a handoff from the row above)
    for label, cw, ch in (("row", mb_w, 1), ("column", 1, mb_h)):
        a = [x[:, :16 * ch, :16 * cw] if i == 0 else
             x[:, :8 * ch, :8 * cw] if i < 3 else x[:, :ch, :cw]
             for i, x in enumerate(p_args[:8])]
        a = [x.contiguous() for x in a] + [0, 0, cw, ch]
        ms = time_cuda(lambda: DB.deblock_frame_cuda(*a), args.reps)
        rec[f"deblock[P]_one_{label}_{cw}x{ch}_us_per_mb"] = \
            1e3 * ms / (cw * ch)
    timed("luma_windows", lambda: MG.luma_windows_cuda(ref4, mb_w, mb_h))
    rec["luma_windows_digest"] = digest(MG.luma_windows_cuda(ref4, mb_w,
                                                             mb_h))
    del ref4
    # K2b on one padded chroma plane per stream
    refc = MC.pad_chroma(t(rng.integers(0, 256, (S, H // 2, W // 2)),
                           torch.uint8)).contiguous()
    timed("chroma_windows",
          lambda: MG.chroma_windows_cuda(refc, mb_w, mb_h))
    out = MG.chroma_windows_cuda(refc, mb_w, mb_h)
    rec["chroma_windows_digest"] = digest(out)
    rec["chroma_windows_bound_bytes_ms"] = \
        (refc.numel() * 4 + out.numel()) / HBM_BYTES_S * 1e3
    del refc, out
    # K5a / K5b from the lanes of the P-type and the all-intra batch, and
    # their us per critical-path MB step
    lanes = {tag: DB.wave_lanes(*a[3:]) for tag, a in (("P", p_args),
                                                         ("I", i_args))}
    for tag, (luma_l, chroma_l) in lanes.items():
        for name, fn, a in (
                ("deblock_wave_luma", DB.deblock_wave_luma_cuda,
                 (y, *luma_l, mb_w, mb_h)),
                ("deblock_wave_chroma", DB.deblock_wave_chroma_cuda,
                 (u, v, *chroma_l, mb_w, mb_h))):
            key = f"{name}[{tag}]"
            ms = timed(key, lambda f=fn, a=a: f(*a))
            rec[f"{key}_us_per_step"] = 1e3 * ms / steps
            rec[f"{key}_device_us_per_step"] = \
                1e3 * rec[f"{key}_device_ms"] / steps
            rec[f"{key}_digest"] = digest(*((fn(*a),) if name.endswith(
                "luma") else fn(*a)))
    luma_l, chroma_l = lanes["P"]
    # K6 on the longest diagonal of all streams (S x 60 = 480 regions)
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
    regs = (regy, regc, ly[0], lc[0], ly[1], ly[2], lc[1], lc[2], ly[3],
            ly[4], lc[3], lc[4])
    rec["filter_regions_regions"] = S * k
    timed("filter_regions", lambda: DB.filter_regions_cuda(*regs))
    rec["filter_regions_digest"] = digest(*DB.filter_regions_cuda(*regs))
    rec["filter_regions_bound_bytes_ms"] = \
        (sum(x.numel() for x in regs) + regy.numel() + regc.numel()) * 4 \
        / HBM_BYTES_S * 1e3
    if hasattr(me_sad, "check_pixels"):
        rec.update(range_check(me_sad, t, rng, mb_w, mb_h, args.reps))
    if args.ptxas:
        lines = ptxas(root, _build)
        for line in lines:
            print(line)
        rec["ptxas"] = ptxas_usage(lines, DEBLOCK_KERNELS)
    if args.sass:
        for name, v in sad_sass(_build, probe).items():
            print(f"sass {name}: {json.dumps(v)}")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
