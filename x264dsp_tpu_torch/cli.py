"""Command-line encoder — equivalent of the reference's x264.c, on the port's
Encoder.

Like the reference (x264.c:94-143), takes positional in.yuv / out.264,
parses WxH from the input filename, and prints fps/bitrate progress. A few
optional flags expose the knobs the reference sets only via code (the
reference CLI parses no flags, x264.c:101-104). --device picks where the
Encoder runs: the GPU ("cuda", the default; it raises without one) or
"cpu".

Usage: python -m x264dsp_tpu_torch.cli IN_WxH.yuv OUT.264 [--qp N]
       [--cavlc] [--keyint N] [--frames N] [--device cuda|cpu]

Port of x264dsp_tpu/cli.py: the same flags, status lines and drain, plus
--device.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import Encoder, Picture, param_default, params as P
from .utils.annexb import AnnexBWriter
from .utils.yuv import YUVReader


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default="704x576.yuv")
    ap.add_argument("output", nargs="?", default="out.264")
    ap.add_argument("--qp", type=int, default=None,
                    help="constant QP (switches RC to CQP)")
    ap.add_argument("--crf", type=float, default=None)
    ap.add_argument("--bitrate", type=int, default=None, help="ABR kbps")
    ap.add_argument("--vbv-maxrate", type=int, default=None,
                    help="VBV max bitrate (kbps)")
    ap.add_argument("--vbv-bufsize", type=int, default=None,
                    help="VBV buffer size (kbit)")
    ap.add_argument("--cavlc", action="store_true")
    ap.add_argument("--keyint", type=int, default=None)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--ssim", action="store_true")
    ap.add_argument("--psnr", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the Encoder runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    with YUVReader(args.input) as reader:
        return _run(args, reader)


def _run(args, reader):
    """The Encoder's parameters from the flags and the input's size, the
    Encoder on args.device, then the encode into args.output (closed
    whatever happens)."""
    param = param_default()
    param.i_width, param.i_height = reader.width, reader.height
    if args.qp is not None:
        param.rc.i_rc_method = P.RC_CQP
        param.rc.i_qp_constant = args.qp
    elif args.bitrate is not None:
        param.rc.i_rc_method = P.RC_ABR
        param.rc.i_bitrate = args.bitrate
    elif args.crf is not None:
        param.rc.f_rf_constant = args.crf
    if args.vbv_maxrate is not None:
        param.rc.i_vbv_max_bitrate = args.vbv_maxrate
    if args.vbv_bufsize is not None:
        param.rc.i_vbv_buffer_size = args.vbv_bufsize
    if args.cavlc:
        param.b_cabac = 0
    if args.keyint is not None:
        param.i_keyint_max = args.keyint
    if args.ssim:
        param.analyse.b_ssim = 1
    if args.psnr:
        param.analyse.b_psnr = 1

    n_frames = reader.num_frames
    if args.frames:
        n_frames = min(n_frames, args.frames)

    print(f"input [info]: {reader.width}x{reader.height}p @ "
          f"{param.i_fps_num}/{param.i_fps_den} fps")
    enc = Encoder(param, device=args.device)
    out = AnnexBWriter(args.output)
    try:
        _encode(param, reader, enc, out, n_frames)
    finally:
        out.close()
    return 0


def _encode(param, reader, enc, out, n_frames):
    """Encode n_frames of `reader` with `enc` into `out`, then drain and
    close the Encoder; prints the status lines of x264.c."""
    t0 = time.time()
    total_bytes = 0
    last_status = 0.0
    # PTS bookkeeping (x264.c:260-271): with the YUV demuxer input is
    # CFR, so pts = frame index; non-strictly-monotonic timestamps are
    # patched to largest + 1 tick with a warning, like the reference
    largest_pts = -1
    pts_warning_cnt = 0
    for i in range(n_frames):
        planes = reader.read_frame(i)
        if planes is None:
            break
        pts = i
        if pts <= largest_pts:
            if pts_warning_cnt < 3:
                print(f"x264 [warning]: non-strictly-monotonic pts at "
                      f"frame {i} ({pts} <= {largest_pts})")
            elif pts_warning_cnt == 3:
                print("x264 [warning]: too many non-monotonic pts "
                      "warnings, suppressing further ones")
            pts_warning_cnt += 1
            pts = largest_pts + 1
        largest_pts = pts
        nals, _ = enc.encode(Picture.from_planes(*planes, pts=pts))
        payload = b"".join(n.payload for n in nals)
        out.write_frame(payload)
        total_bytes += len(payload)
        # print_status twin (x264.c:165-193): 1 Hz progress with eta
        now = time.time()
        if now - last_status >= 1.0 and i + 1 < n_frames:
            last_status = now
            el = max(now - t0, 1e-9)
            enc_fps = (i + 1) / el
            kbps = (total_bytes * 8 * (param.i_fps_num / param.i_fps_den)
                    / (i + 1) / 1000)
            eta = int(el * (n_frames - i - 1) / (i + 1))
            print(f"x264 [{100.0 * (i + 1) / n_frames:.1f}%] "
                  f"{i + 1}/{n_frames} frames, {enc_fps:.2f} fps, "
                  f"{kbps:.2f} kb/s, eta {eta // 3600}:"
                  f"{eta // 60 % 60:02d}:{eta % 60:02d}", flush=True)
    # drain frames delayed in the lookahead queue (x264.c:284-293)
    while True:
        nals, _ = enc.encode(None)
        if not nals:
            break
        payload = b"".join(n.payload for n in nals)
        out.write_frame(payload)
        total_bytes += len(payload)
    elapsed = max(time.time() - t0, 1e-9)
    fps = param.i_fps_num / param.i_fps_den
    kbps = total_bytes * 8 * fps / max(n_frames, 1) / 1000
    print(f"encoded {n_frames} frames, {n_frames / elapsed:.2f} fps, "
          f"{kbps:.2f} kb/s")
    stats = enc.close()
    print("x264dsp_tpu_torch [info]:", stats)


if __name__ == "__main__":
    sys.exit(main())
