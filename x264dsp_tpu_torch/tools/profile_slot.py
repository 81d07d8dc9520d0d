"""Where a BatchEncoder slot's time goes on one GPU.

    python -m x264dsp_tpu_torch.tools.profile_slot [--streams 8]
                                                  [--corner 128x64]

Two measurements on the main path's synthetic clip and settings
(tools/mainpath.py), each printed on a labelled line:

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--corner", default="128x64",
                    help="WxH of the I-frame corner, multiples of 16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu.ops.tables import CHROMA_QP_TABLE
    from x264dsp_tpu_torch.encoder import core as C
    from x264dsp_tpu_torch.encoder import intra_frame
    from x264dsp_tpu_torch.ops import mc as MC
    from .mainpath import main_path_param, stacked_slot, synth_clip

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

    # ---- P step
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
    print(f"P step {W}x{H} S={S} QP {qp}: unprofiled {t * 1e3:.2f} ms")
    tp, n_ops, busy, per = device_profile(run_p)
    print(f"P step profiled: wall {tp * 1e3:.2f} ms, device {busy:.2f} ms"
          f" = {100 * busy / (tp * 1e3):.1f}% of the profiled wall, "
          f"{100 * busy / (t * 1e3):.1f}% of the unprofiled wall; "
          f"{n_ops} device ops")
    print("P step kernels, device ms: "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in per.items())
          + f" (sum {sum(per.values()):.3f})")
    be.close()


if __name__ == "__main__":
    main()
