"""Where a BatchEncoder slot's time goes on one GPU.

    python -m x264dsp_tpu_torch.tools.profile_slot [--streams 8]
                                                  [--corner 128x64]

Three measurements, each printed on labelled lines; the first two on
the main path's synthetic clip and settings (tools/mainpath.py):

  I corner   encode_i_frame, the I slot's encode stage, on the top-left
             corner of S streams (128x64: 14 wavefront diagonals; a
             1920x1088 frame has 254). The unprofiled wall per diagonal
             (synchronized), then one torch.profiler run: its wall, the
             device time, the device's busy share of that wall and the
             device operations per diagonal.
  P step     one P core.frame_step (encode, deblock, reference planes) at
             1920x1088 for S streams, the main path's shape, on reference
             planes made from the clip's previous frame: the unprofiled
             wall, then one profiled run as above, and each hand-written
             kernel's device time in that run.
  P step faster-1ref
             the same for faster-1ref (HEX, subme 4, 16x8/8x16/8x8
             partitions; kernel K4 in place of K1) on the split-motion
             clip.

Each P step also prints its stage split ("P step ... stages"): one more
run with a device sync around each stage of encode_p_frame (the full-pel
surfaces, the windows, the MV decision, the P-skip probe, the partition
analysis, the residual, the strengths) and of frame_step (deblock,
reference planes).

Device time is the sum of the CUDA activity the profiler records
(kernels, copies, memsets); the step runs on one stream, so that
activity does not overlap itself. The profiler adds host time, so the
busy share of the profiled wall is a lower bound; the line also gives
the share of the unprofiled wall. Exits non-zero without a CUDA device
or when the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

W, H = 1920, 1088
# device-side names of the csrc/ kernels, as the profiler reports them
KERNELS = {"K1 sad_surface16": "sad_surface16_kernel",
           "K4 sad_surfaces_8x8": "sad_surfaces_8x8_kernel",
           "K2a luma_windows": "luma_windows_kernel",
           "K2b chroma_windows": "chroma_windows_kernel",
           "K3 deblock": "deblock_kernel"}


def wall(fn) -> float:
    """Seconds for one synchronized call of fn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_profile(fn):
    """One call of fn under torch.profiler. Returns (wall s, device ops,
    device ms, {kernel label: device ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = wall(fn)
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        sys.exit("torch.profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    per = {label: sum(e.time_range.elapsed_us() for e in ev
                      if name in e.name) / 1e3
           for label, name in KERNELS.items()}
    return t, len(ev), busy, per


def stage_split(fn) -> dict:
    """One call of fn with a device sync around each stage of the P step:
    {stage: ms}. The stages are the module functions that encode_p_frame
    and frame_step call, wrapped for the call and restored after it."""
    from x264dsp_tpu_torch.encoder import core, inter_frame
    from x264dsp_tpu_torch.ops import mc, mcgather, me_sad
    stages = {"surfaces": [(me_sad, "sad_cost_surface16_lanes"),
                           (inter_frame, "fullpel_cost_surfaces_8x8")],
              "windows": [(mcgather, "luma_windows"),
                          (mcgather, "chroma_windows")],
              "mv decision": [(inter_frame, "decide_mvs_pattern")],
              "pskip probe": [(inter_frame, "probe_pskip")],
              "partitions": [(inter_frame, "decide_partitions")],
              "residual": [(inter_frame, "encode_p_residual")],
              "strengths": [(inter_frame, "compute_strengths_p")],
              "deblock": [(core.DB, "deblock_frame")],
              "ref planes": [(mc, "make_ref_planes"), (mc, "pad_chroma")]}
    ms = dict.fromkeys(stages, 0.0)
    saved = []

    def timed(stage, f):
        def g(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = f(*a, **k)
            torch.cuda.synchronize()
            ms[stage] += (time.perf_counter() - t0) * 1e3
            return r
        return g
    for stage, where in stages.items():
        for mod, name in where:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, timed(stage, getattr(mod, name)))
    try:
        total = wall(fn) * 1e3
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    ms["other"] = total - sum(ms.values())
    return ms


def p_step(label, be, frame, S, dev, grid):
    """Measure one P frame_step of `be`'s settings on slots 0 -> 1 of
    `frame` (the P step lines of the module docstring)."""
    from x264dsp_tpu_torch.encoder import core as C
    from x264dsp_tpu_torch.ops import mc as MC
    from .mainpath import stacked_slot
    import x264dsp_tpu_torch as xtt
    qp = be.slot_qp(xtt.SLICE_TYPE_P)
    cfg = be.frame_cfg(qp)
    mb_w, mb_h = W // 16, H // 16
    py, pu, pv = stacked_slot(frame, 0, S)
    refs = (MC.make_ref_planes(py).contiguous(),
            MC.pad_chroma(pu).contiguous(), MC.pad_chroma(pv).contiguous())
    cur = stacked_slot(frame, 1, S)
    qp_mb = grid(qp, mb_w, mb_h)
    lam = grid(C.LAMBDA_TAB[qp], mb_w, mb_h)
    clock = C.StageClock(dev, False)

    def run_p():
        C.frame_step(cfg, True, *cur, refs, qp_mb, lam, qp, clock)
    run_p()                                        # warm-up
    t = wall(run_p)
    print(f"{label} {W}x{H} S={S} QP {qp}: unprofiled {t * 1e3:.2f} ms")
    tp, n_ops, busy, per = device_profile(run_p)
    print(f"{label} profiled: wall {tp * 1e3:.2f} ms, device {busy:.2f} ms"
          f" = {100 * busy / (tp * 1e3):.1f}% of the profiled wall, "
          f"{100 * busy / (t * 1e3):.1f}% of the unprofiled wall; "
          f"{n_ops} device ops")
    print(f"{label} kernels, device ms: "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in per.items())
          + f" (sum {sum(per.values()):.3f})")
    split = stage_split(run_p)
    print(f"{label} stages, synchronized ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f" (sum {sum(split.values()):.2f})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--corner", default="128x64",
                    help="WxH of the I-frame corner, multiples of 16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch.ops.tables import CHROMA_QP_TABLE
    from x264dsp_tpu_torch.encoder import core as C
    from x264dsp_tpu_torch.encoder import intra_frame
    from .mainpath import (faster_1ref_param, main_path_param,
                           split_motion_clip, stacked_slot, synth_clip)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    S = args.streams
    frame = synth_clip(W, H, dev)
    be = xtt.BatchEncoder(main_path_param(W, H), S, device="cuda")

    def grid(v, mb_w, mb_h):
        return torch.full((S, mb_h, mb_w), int(v), dtype=torch.int32,
                          device=dev)

    # ---- I corner
    cw, ch = (int(x) for x in args.corner.split("x"))
    mb_w, mb_h = cw // 16, ch // 16
    n_diag = mb_w + 2 * mb_h - 2
    y, u, v = stacked_slot(frame, 0, S)
    fy = y[:, :ch, :cw].contiguous()
    fu = u[:, :ch // 2, :cw // 2].contiguous()
    fv = v[:, :ch // 2, :cw // 2].contiguous()
    qp = be.slot_qp(xtt.SLICE_TYPE_I)
    cfg = be.frame_cfg(qp)
    qpc = CHROMA_QP_TABLE[min(max(qp + cfg["cqpo"], 0), 51)]
    g = (grid(qp, mb_w, mb_h), grid(qpc, mb_w, mb_h),
         grid(C.LAMBDA_TAB[qp], mb_w, mb_h))

    def run_i():
        intra_frame.encode_i_frame(fy, fu, fv, *g, mb_w, mb_h,
                                   cfg["use_satd"], cfg["i4x4"])
    run_i()                                        # warm-up
    t = wall(run_i)
    print(f"I corner {cw}x{ch} S={S} QP {qp}, {n_diag} diagonals: "
          f"unprofiled {t * 1e3:.1f} ms = {t * 1e3 / n_diag:.2f} ms "
          f"per diagonal")
    tp, n_ops, busy, _ = device_profile(run_i)
    print(f"I corner profiled: wall {tp * 1e3:.1f} ms, device {busy:.2f} ms"
          f" = {100 * busy / (tp * 1e3):.1f}% of the profiled wall, "
          f"{100 * busy / (t * 1e3):.1f}% of the unprofiled wall; "
          f"{n_ops} device ops = {n_ops / n_diag:.0f} per diagonal")

    # ---- P steps: the main path, then faster-1ref
    p_step("P step", be, frame, S, dev, grid)
    be.close()
    be = xtt.BatchEncoder(faster_1ref_param(W, H), S, device="cuda")
    p_step("P step faster-1ref", be, split_motion_clip(W, H, dev), S, dev,
           grid)
    be.close()


if __name__ == "__main__":
    main()
