"""Smoke run of the PyTorch / CUDA port on one GPU: python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. setup: the card's name and power limit, the CUDA kernel build (one
     nvcc per source, all started together);
  2. each hand-written kernel (K1 SAD surface, K2a/K2b MC windows, K3
     deblock, K4 quadrant SAD surfaces, K5a/K5b wave deblock, K6 region
     filter, the DIA / HEX full-pel walk) against its plain PyTorch
     version at the 1920x1088 shapes
     (R = 16, S = 8; K6 at one full diagonal of all streams, 480
     regions; K1, K2a, K2b, K3 also at S = 1, phase 8's shapes, K4 at
     phase 10's, and K1, K2a, K2b at phase 11's: the four 17-row slice
     bands of one 1080p frame on the stream axis; the walk at the
     benchmark cells' shapes, a P frame's three walks per call: DIA over
     K1's lanes at S = 32 and HEX over the classic layout at S = 16),
     exact equality, with
     CUDA-event times over back-to-back calls (ms: the host's time
     where a call's wrapper and launch take longer than the kernel, as
     K6's do), the kernel's own device time
     per launch from torch.profiler (device_ms), the least time the
     card could take for the same work (bound_ms; for K1 and K4 their
     packed four-byte SADs at the int32 peak, beside the rate that the
     probe x264dsp_tpu_torch/tools/sad_rate.cu measures in this run) and,
     where one PyTorch call computes the same function, that call's time
     (library_ms); K3, K5a and K5b also in us per critical-path MB step
     (254 at 1080p), with the registers, stack and spills that ptxas
     reports for them and K6; the wave and region deblock routes against
     K3 on the same frame;
  3. the BatchEncoder on the GPU against the same on the CPU (both pack
     CAVLC with the device packer): the main path on a 64x48 clip and
     faster-1ref (HEX, subme 4, partitions) on a 64x64 split-motion clip
     (S = 2, keyint 4, 6 frames each): identical Annex-B bytes, also with
     the slots on the wave and on the region deblock route; and on a
     64x48 clip whose two streams differ in detail, CRF 30 with UMH and
     subme 0, and ABR at 200 kbit/s with ESA, subme 2 and partitions:
     identical bytes and per-stream QPs; and the single-stream Encoder on
     a 56x40 clip with a scene cut (8 frames, the card's frames as CUDA
     tensors, the CPU's as numpy), at param_default() (CRF 28, CABAC),
     at CQP 20 + CABAC + HEX, subme 4, partitions with forced frame types
     and QPs, and at phase 9's live-stream CBR (NAL HRD, variance AQ, the
     lookahead queue of 4 frames) cut to 40 kbit/s with a 6 kbit buffer,
     so that the row-VBV walk re-encodes and the CPB overflows into filler
     NALs, under CABAC and under CAVLC (whose row bits come from the
     device packer), and on tools/mainpath.py's 56x40 multi-ref clip at
     3 references with the JVT scaling lists and noise reduction 100,
     its newest reference marked corrupt before frame 5 and every one
     before its extreme last frame 6 (an IDR that no valid reference
     forces) at QP 0, under CAVLC (the overflow re-encode must fire) and
     CABAC: identical
     headers, calls that return no frame, NALs, frame types, QPs, pic_out
     planes and close() summary; the Encoder with several slices per
     frame and with intra refresh on tools/mainpath.py's 64x96 slices
     clip (5 frames, CQP 26; every case of mainpath.SLICE_CASES: 3 slices
     under CAVLC and CABAC, slices of at most 8 MBs, 3 slices under a
     400-byte slice budget (the I frame's slices are split), intra
     refresh with 3 slices and keyint 4 (frame 4 stays P), 3 slices under
     a tight VBV, 3 slices with 2 references (K4 on the stacked band
     crops)), the card's Encoder profiled (a device sync at each stage):
     the same checks, one slice NAL per band, and K1, K2a, K2b and K3
     launched (K4 too with 2 references); the CLI on the scene-cut clip as a 56x40 .yuv (under
     build/smoke/) with --device cuda against --device cpu: identical .264
     bytes; and the stream mesh (parallel/mesh.py): the I step and the P
     pipeline (ESA) of 4 streams at 64x48 over a two-entry mesh of the
     card (two cards when there are two) against a two-entry CPU mesh:
     identical outputs;
  4. the main path: BatchEncoder at 1920x1088, S = 8, QP 26, keyint 50,
     CAVLC, DIA, subme 1, one I slot and four P slots of a synthetic clip;
     prints fps and the per-stage split, and holds the device payload of
     the I slot and the first P slot, every stream, to the host C++
     writers on the pulled syntax;
  5. faster-1ref: the same BatchEncoder with HEX, subme 4 and the
     16x8/8x16/8x8 partitions, one I slot and two P slots of a
     split-motion clip, unprofiled; prints fps and the partition counts;
  6. the deblock routes at full width: the main-path clip again, one I
     and three P slots, the I slot and the first P slot on the wave route,
     the second P slot on the region route, the third on the default:
     the bytes of phase 4's first four slots, K5a and K5b launched twice
     and K6 once per diagonal;
  7. v2: the BatchEncoder's per-stream rate control at full width, CRF 23
     (x264's default) with the ESA search and otherwise the main path's
     settings, one I and two P slots of the synthetic clip with a luma
     noise scale per stream, profiled; holds the device payload of every
     slot, every stream with its own slice header and QP, to the host C++
     writers, prints each stream's QP per slot (two streams must differ in
     some slot), the stage split with the lowres cost pass and the fps;
  8. encoder: the single-stream Encoder at param_default() (CRF 28,
     CABAC through the host C++ writer, scenecut 20, keyint 50) at
     1920x1080 on stream 0 of phase 4's clip cut to 1080 rows, one I and
     three P frames given as CUDA tensors, unprofiled (fps, each frame's
     type, QP, bytes and wall); and a CAVLC twin of the first two frames, each forced to the
     CRF run's QP, whose pic_out must equal the CABAC run's, whose device
     CAVLC payload must equal the host C++ writers' and whose syntax,
     written by the C++ CABAC writer, must give the CABAC run's slices;
     and the device CABAC front half on the twin's two frames:
     residual_ops_frame on the card (cap_ops 1 << 22) equal to the CPU's,
     and the C++ CABAC writer's bytes with its op stream equal to its own
     binarization's, with the card's ms and the writer's host ms both
     ways;
  9. encoder-cbr: the Encoder as a live stream into an ingest server at
     1920x1080, 30 fps, keyint 60: CBR at 6000 kbit/s (ABR with VBV max
     rate = buffer = 6000 kbit, NAL HRD CBR), variance AQ at strength 1.0,
     i_lookahead 4, the rest param_default(). The stream opens on a flat
     slate for 4 frames (an IDR and 3 P: the CPB starts 90% full and the
     slate spends almost nothing, so it overflows into filler), then cuts
     to stream 0 of phase 4's clip cut to 1080 rows for 5 P frames (the
     cut falls inside keyint_min: no IDR), all as CUDA tensors, then the
     drain with encode(None): the fps, each frame's type, QP (and the
     range of its per-MB QPs), bytes, filler bytes and device encodes,
     the buffering-period SEI's delay and offset, unprofiled. Requires
     K1, K2a, K2b and K3 launches, an AQ spread on some frame, a filler
     NAL and a luma PSNR of 30 dB or more.
 10. encoder-refs: the Encoder at 1920x1080 with x264 --preset medium's
     three references, the JVT scaling lists, noise reduction 100 and
     CAVLC, one I and four P frames of phase 4's clip cut to 1080 rows,
     the newest reference marked corrupt before the last frame,
     unprofiled: the fps, each frame's type, QP, bytes, active
     reference count and wall time, the reference histogram. Requires
     K1 (the first P frame has one reference), K4 (the others two or
     three, on the stream axis), K2a, K2b and K3 launches, the reordered
     last frame and a luma PSNR of 30 dB or more; phase 2 holds K4 at
     its shape.
 11. encoder-slices: the Encoder at param_default() (CRF 28, CABAC) with 4
     slices per frame (Blu-ray authoring's --slices 4) at 1920x1080, one
     I and two P frames of phase 8's frames, unprofiled: the fps, each
     frame's type, QP, bytes, slice NALs, bands and wall (beside phase
     8's single-slice walls). The bands of one height run as the streams
     of one frame-step call, and K3 filters the assembled frame across
     the slice edges. Requires K1, K2a, K2b and K3 launches, 4 bands of
     17 MB rows and 4 slice NALs on every frame and a luma PSNR of 30 dB
     or more.
 12. multichip: the stream mesh (parallel/mesh.py) over every card torch
     sees when there are two or more, else over cuda:0 twice (logical
     shards of one card): dryrun_multichip (parallel/dryrun.py) at QCIF,
     one stream per shard (a sharded I step, the sharded P pipeline on the
     ESA wavefront, the device CAVLC packer per shard byte-identical to a
     single-device twin, the C++ CABAC writer per stream, the Encoder with
     2 slices under row VBV), then the P pipeline (ESA) at 1920x1088, S =
     8, on phase 4's clip (frame 1 against the reference planes of frame
     0's source) sharded over the mesh and unsharded on cuda:0: every
     output and reference plane equal; each part's wall and launches.
     Requires K4, K2a, K2b and K3 launches in the sharded run.
Phases 4 to 12 each set the launch counters to 0 just before they drive
the encoder and read them just after; a kernel of the path that was
never launched fails the run (the walk in every phase that searches
with DIA or HEX: 4, 5, 6, 8, 9, 10 and 11). The line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}. Imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
W, H, S_MAIN, QP, KEYINT = 1920, 1088, 8, 26, 50
R = 16
WALKS = 3           # full-pel walks per DIA / HEX P frame
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, and
# int32 operations/s outside the tensor cores: 132 SMs x 64 int32 lanes x
# 1.98 GHz, half the fp32 rate of 67 TFLOP/s (132 x 128 lanes x 2 x 1.98)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def setup():
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi failed: " + smi.stderr)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    from x264dsp_tpu_torch import _build
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    return line


def time_cuda(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
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


def max_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(moved: int, int_ops: int):
    """(ms, "bytes" or "operations"): the least time for `moved` bytes
    (each input read once, each output written once) and `int_ops` int32
    operations on the card's peak rates."""
    t_bytes = moved / HBM_BYTES_S * 1e3
    t_ops = int_ops / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks():
    """Phase 2: every kernel against its plain version, full-size shapes."""
    import torch
    from x264dsp_tpu_torch.ops.tables import CHROMA_QP_TABLE
    from x264dsp_tpu_torch.ops import deblock as DB
    from x264dsp_tpu_torch.ops import mc as MC
    from x264dsp_tpu_torch.ops import mcgather as MG
    from x264dsp_tpu_torch.ops import me_sad
    from x264dsp_tpu_torch import _build
    from x264dsp_tpu_torch.tools.kernel_ab import (DEBLOCK_KERNELS,
                                                   device_ms, ptxas,
                                                   ptxas_usage)
    dev = torch.device("cuda")
    usage = ptxas_usage(ptxas(ROOT, _build, ("deblock.cu",)),
                        DEBLOCK_KERNELS)
    for kname in DEBLOCK_KERNELS:
        use = usage.get(kname)
        if not use:
            fail(f"ptxas reported nothing for {kname}")
        print(f"ptxas {kname}: {use['registers']} registers, "
              f"{use['stack']} bytes stack, {use['spill_stores']} bytes "
              f"spill stores, {use['spill_loads']} bytes spill loads")
    mb_w, mb_h = W // 16, H // 16
    n = 2 * R + 1
    rec = []

    # K1 and K4 sum four packed byte differences per instruction
    # (VABSDIFF4.U8.ACC, issued at the int32 rate: 64 lanes per SM and
    # clock), so their operations are S H W n^2 / 4 packed sums at
    # INT32_OPS_S. The probe (x264dsp_tpu_torch/tools/sad_rate.cu) measures
    # the rate the instruction reaches on this card, printed beside the
    # bound with the int32 formulation's bound (a subtract-absolute and an
    # add per pixel and offset).
    from x264dsp_tpu_torch.tools import sad_rate
    rate = sad_rate.rate()
    print(f"packed SAD rate (probe): {rate:.4e} sums/s = "
          f"{rate / INT32_OPS_S:.3f} of the {INT32_OPS_S:.4e} peak")

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    # the library calls: one strided view of the padded planes and one
    # copy with the uint8 conversion (never called by the port)
    def luma_lib(ref4, mb_h):
        S, _, Hp, Wp = ref4.shape
        o = MC.PAD_MC - MG.M_LUMA
        v = ref4.as_strided(
            (S, mb_h, mb_w, 4, MG.WIN_L, MG.WIN_L),
            (4 * Hp * Wp, 16 * Wp, 16, Hp * Wp, Wp, 1), o * Wp + o)
        return v.to(torch.uint8).reshape(S, mb_h * mb_w, 4, MG.WIN_L,
                                         MG.WIN_L)

    def chroma_lib(refc, mb_h):
        S, Hc, Wc = refc.shape
        o = MC.PAD_MC // 2 - MG.M_CHROMA
        v = refc.as_strided((S, mb_h, mb_w, MG.WIN_C, MG.WIN_C),
                            (Hc * Wc, 8 * Wc, 8, Wc, 1), o * Wc + o)
        return v.to(torch.uint8).reshape(S, mb_h * mb_w, MG.WIN_C,
                                         MG.WIN_C)

    def motion_cases(tag, fenc, ref4, refc, strips, rows):
        """K1, K2a and K2b on S streams of `rows` MB rows: fenc (S, 16 rows,
        W), ref4 / refc their padded reference planes, strips K1's search
        strips of ref4."""
        S = fenc.shape[0]
        n_mb = S * rows * mb_w
        return [
            (f"sad_surface16{tag}", "x264dsp_tpu_torch/csrc/me_sad.cu",
             "x264dsp_tpu/ops/pallas/me_sad.py:138",
             lambda: me_sad.sad_cost_surface16_lanes_cuda(fenc, strips,
                                                          mb_w, rows, R),
             lambda: me_sad.sad_cost_surface16_lanes_plain(fenc, strips,
                                                           mb_w, rows, R),
             None, 10, 1, (nbytes(fenc, strips) + 4 * n_mb * n * n,
                           fenc.numel() * n * n // 4)),
            (f"luma_windows{tag}", "x264dsp_tpu_torch/csrc/windows.cu",
             "x264dsp_tpu/ops/pallas/windows.py:30",
             lambda: MG.luma_windows_cuda(ref4, mb_w, rows),
             lambda: MG.luma_windows_plain(ref4, mb_w, rows),
             lambda: luma_lib(ref4, rows), 10, 3,
             (nbytes(ref4) + n_mb * 4 * MG.WIN_L ** 2, 0)),
            (f"chroma_windows{tag}", "x264dsp_tpu_torch/csrc/windows.cu",
             "x264dsp_tpu/ops/pallas/windows.py:68",
             lambda: MG.chroma_windows_cuda(refc, mb_w, rows),
             lambda: MG.chroma_windows_plain(refc, mb_w, rows),
             lambda: chroma_lib(refc, rows), 10, 3,
             (nbytes(refc) + n_mb * MG.WIN_C ** 2, 0))]

    def band_cases(rng, n_bands=4):
        """K1, K2a and K2b at phase 11's shape: the n_bands slice bands of
        one 1080p frame (17 MB rows each) on the stream axis, each band's
        rows of the padded reference planes with its neighbours' real rows
        (EncoderCore._encode_bands), tagged "S=4 bands"."""
        rows = mb_h // n_bands
        hb, pad = 16 * rows, MC.PAD_MC
        ref4 = MC.make_ref_planes(t(rng.integers(0, 256, (1, H, W)),
                                    torch.uint8))
        refc = MC.pad_chroma(t(rng.integers(0, 256, (1, H // 2, W // 2)),
                               torch.uint8))
        ref4 = torch.cat([ref4[:, :, i * hb:(i + 1) * hb + 2 * pad]
                          for i in range(n_bands)])
        refc = torch.cat([refc[:, i * hb // 2:(i + 1) * hb // 2 + pad]
                          for i in range(n_bands)])
        fenc = t(rng.integers(0, 256, (n_bands, hb, W)))
        strips = me_sad.make_ref_strips(ref4[:, 0], pad, mb_w, rows, R)
        return [c + (n_bands,) for c in motion_cases(
            f"[S={n_bands} bands]", fenc, ref4, refc, strips, rows)]

    def cases_at(S: int, rng):
        """The cases at S streams: every kernel at S = S_MAIN; at S = 1
        the four of phase 8's path (K1, K2a, K2b, K3), tagged "S=1" in
        their names, and K4 at phase 10's shape (one frame beside three
        references). Returns (cases, K3's P-like and I-like arguments)."""
        full = S == S_MAIN
        tag1 = "" if full else "S=1"

        def name(base, tag=""):
            tags = ",".join(x for x in (tag, tag1) if x)
            return f"{base}[{tags}]" if tags else base
        fenc = t(rng.integers(0, 256, (S, H, W)))
        recon = t(rng.integers(0, 256, (S, H, W)), torch.uint8)
        ref4 = MC.make_ref_planes(recon).contiguous()
        strips = me_sad.make_ref_strips(ref4[:, 0], MC.PAD_MC, mb_w, mb_h, R)
        refc = MC.pad_chroma(t(rng.integers(0, 256, (S, H // 2, W // 2)),
                               torch.uint8)).contiguous()
        sad_sums = S * H * W * n * n // 4
        sad_in = nbytes(fenc, strips)
        # name, source, TPU kernel, kernel, plain, library call or None,
        # kernel reps, plain reps, (bytes moved, operations at the int32
        # rate: for K1 and K4 their packed sums)
        cases = motion_cases(f"[{tag1}]" if tag1 else "", fenc, ref4, refc,
                             strips, mb_h)
        if full:
            cases.insert(1, (
                "sad_surfaces_8x8", "x264dsp_tpu_torch/csrc/me_sad.cu",
                "x264dsp_tpu/ops/pallas/me_sad.py:72",
                lambda: me_sad.sad_cost_surfaces_8x8_cuda(fenc, strips,
                                                          mb_w, mb_h, R),
                lambda: me_sad.sad_cost_surfaces_8x8_plain(fenc, strips,
                                                           mb_w, mb_h, R),
                None, 10, 1, (sad_in + 16 * S * mb_h * mb_w * n * n,
                              sad_sums)))
        else:
            # K4 at phase 10's shape: the Encoder's frame beside its three
            # references on the stream axis (one launch per P frame)
            nr = 3
            fenc_r = fenc.expand(nr, H, W).contiguous()
            strips_r = me_sad.make_ref_strips(
                MC.make_ref_planes(t(rng.integers(0, 256, (nr, H, W)),
                                     torch.uint8))[:, 0].contiguous(),
                MC.PAD_MC, mb_w, mb_h, R)
            cases.insert(1, (
                f"sad_surfaces_8x8[S=1,{nr} refs]",
                "x264dsp_tpu_torch/csrc/me_sad.cu",
                "x264dsp_tpu/ops/pallas/me_sad.py:72",
                lambda: me_sad.sad_cost_surfaces_8x8_cuda(fenc_r, strips_r,
                                                          mb_w, mb_h, R),
                lambda: me_sad.sad_cost_surfaces_8x8_plain(fenc_r, strips_r,
                                                           mb_w, mb_h, R),
                None, 10, 1, (nbytes(fenc_r, strips_r)
                              + 16 * nr * mb_h * mb_w * n * n,
                              nr * sad_sums)))
        # K3: a P-like case (no intra MBs, random bS 0..2, skips) and an
        # I-like case (every MB intra, bS 3), per-MB QP grids
        blocky = np.kron(rng.integers(0, 256, (S, mb_h * 4, mb_w * 4)),
                         np.ones((1, 4, 4), np.int64))
        y = t((blocky + rng.integers(-6, 7, (S, H, W))).clip(0, 255))
        cu = np.kron(rng.integers(0, 256, (S, mb_h * 2, mb_w * 2)),
                     np.ones((1, 4, 4), np.int64))
        u, v = t(cu), t(255 - cu)
        qp = rng.integers(20, 41, (S, mb_h, mb_w))
        qpc = CHROMA_QP_TABLE[qp]
        grid = (S, mb_h, mb_w)
        p_args = (y, u, v, t(rng.integers(0, 3, grid + (2, 4, 4))),
                  t(np.zeros(grid)), t(rng.random(grid) < 0.2), t(qp),
                  t(qpc), 0, 0, mb_w, mb_h)
        i_args = (y, u, v, t(np.full(grid + (2, 4, 4), 3)),
                  t(np.ones(grid)), t(np.zeros(grid)), t(qp), t(qpc), 0, 0,
                  mb_w, mb_h)
        for tag, args in (("P", p_args), ("I", i_args)):
            # bytes only: the planes read and written once, the grids read
            # once; the filter arithmetic is a few operations per edge
            # sample
            dsrc = "x264dsp_tpu_torch/csrc/deblock.cu"
            moved = nbytes(*args[:8]) + nbytes(y, u, v)
            # the plain wavefronts are eager loops over the 254 diagonals
            # (seconds): plain reps 0 = timed once, on the call that is
            # compared
            cases.append((name("deblock", tag), dsrc,
                          "x264dsp_tpu/ops/pallas/deblock_skew.py:258",
                          lambda a=args: DB.deblock_frame_cuda(*a),
                          lambda a=args: DB.deblock_frame_plain(*a), None,
                          10, 0, (moved, 0)))
            if not full:
                continue
            # K5a / K5b: the same frames from the precomputed lanes
            # (planes read and written once, lanes read once)
            luma_l, chroma_l = DB.wave_lanes(*args[3:])
            cases.append((f"deblock_wave_luma[{tag}]", dsrc,
                          "x264dsp_tpu/ops/pallas/deblock_wave.py:270",
                          lambda l=luma_l: DB.deblock_wave_luma_cuda(
                              y, *l, mb_w, mb_h),
                          lambda l=luma_l: DB.deblock_wave_luma_plain(
                              y, *l, mb_w, mb_h), None, 10, 0,
                          (2 * nbytes(y) + nbytes(*luma_l), 0)))
            cases.append((f"deblock_wave_chroma[{tag}]", dsrc,
                          "x264dsp_tpu/ops/pallas/deblock_wave.py:313",
                          lambda l=chroma_l: DB.deblock_wave_chroma_cuda(
                              u, v, *l, mb_w, mb_h),
                          lambda l=chroma_l: DB.deblock_wave_chroma_plain(
                              u, v, *l, mb_w, mb_h), None, 10, 0,
                          (2 * nbytes(u, v) + nbytes(*chroma_l), 0)))
            # K6: the longest diagonal of all streams, S x 60 = 480 regions
            ys, xs = (torch.as_tensor(a, device=dev)
                      for a in DB.diag_slots(mb_w, mb_h))
            d = int((ys >= 0).sum(1).argmax())
            k = int((ys[d] >= 0).sum())
            if S * k % DB.KB:
                fail(f"K6's diagonal has {S * k} regions, no multiple of "
                     f"{DB.KB}")
            F = torch.nn.functional
            ry, rx = DB.region_index(ys[d, :k], xs[d, :k], 16, 20, dev)
            cy, cx = DB.region_index(ys[d, :k], xs[d, :k], 8, 12, dev)
            regy = F.pad(y, (4, 4, 4, 4))[:, ry, rx].reshape(S * k, 20, 20)
            regc = F.pad(torch.stack([u, v], 1), (4, 4, 4, 4))[:, :, cy, cx] \
                .transpose(1, 2).reshape(2 * S * k, 12, 12).contiguous()
            ly = [a[:, d, :k].reshape(S * k, -1).contiguous()
                  for a in luma_l]
            lc = [a[:, d, :2 * k].reshape(2 * S * k, -1).contiguous()
                  for a in chroma_l]
            regs = (regy, regc, ly[0], lc[0], ly[1], ly[2], lc[1], lc[2],
                    ly[3], ly[4], lc[3], lc[4])
            cases.append((f"filter_regions[{tag}]", dsrc,
                          "x264dsp_tpu/ops/pallas/deblock_filter.py:117",
                          lambda r=regs: DB.filter_regions_cuda(*r),
                          lambda r=regs: DB.filter_regions_plain(*r), None,
                          10, 3, (nbytes(*regs) + nbytes(regy, regc), 0)))
        return [c + (S,) for c in cases], p_args, i_args

    def walk_cases():
        """The full-pel walk at the benchmark cells' shapes: DIA over K1's
        lanes at S = 32 (superfast-pan-s32) and HEX over the classic
        layout at S = 16 (faster-split-s16), lambda at QP 26, the legal
        range at mv_range 512. One call is a P slot's WALKS walks (zero
        MVP, then two from the field before). Each MB's surface is a bowl
        around a target up to R + 2 away plus noise, so walks run up to
        the step cap. The bound counts each surface read of the per-MB
        walks once (4 bytes), the lambdas, fields and outputs."""
        from x264dsp_tpu_torch import params as XP
        from x264dsp_tpu_torch.encoder.core import LAMBDA_TAB
        from x264dsp_tpu_torch.encoder.inter_frame import fullpel_bounds
        from x264dsp_tpu_torch.ops import me_walk as ME
        bounds = fullpel_bounds(mb_w, mb_h, 512, dev)
        off = torch.arange(-R, R + 1, device=dev, dtype=torch.int32)
        out = []
        for S, method, lanes, tag in ((32, XP.ME_DIA, True, "DIA,lanes"),
                                      (16, XP.ME_HEX, False, "HEX,classic")):
            g = torch.Generator(device=dev).manual_seed(S)
            shape = (S, mb_h, mb_w, 1, 1)

            def draw(lo, hi):
                return torch.randint(lo, hi, shape, device=dev, generator=g,
                                     dtype=torch.int32)
            tx, ty, a, b = draw(-R - 2, R + 3), draw(-R - 2, R + 3), \
                draw(1, 200), draw(1, 200)
            surf = a * (off[None, :] - tx).abs() + b * (off[:, None]
                                                        - ty).abs()
            surf += (torch.rand(surf.shape, device=dev, generator=g)
                     * (draw(0, 10) * torch.maximum(a, b))).int()
            if lanes:
                surf = surf.permute(0, 1, 3, 4, 2)
            surf = surf.clamp(max=65280).contiguous()
            del tx, ty, a, b
            lam = torch.full((S, mb_h, mb_w), int(LAMBDA_TAB[QP]),
                             dtype=torch.int32, device=dev)

            def chain(fn, s=surf, lanes=lanes, lam=lam, method=method):
                best = None
                for _ in range(WALKS):
                    best, cost, mvp = fn(s, lanes, lam, bounds, best, R,
                                         method)[:3]
                return best, cost, mvp
            best, reads = None, 0
            for _ in range(WALKS):
                best, _, _, r = ME.pattern_walk_plain(
                    surf, lanes, lam, bounds, best, R, method,
                    count_reads=True)
                reads += r
            n_mb = S * mb_h * mb_w
            print(f"pattern_walk[S={S},{tag}]: {reads} surface reads in "
                  f"{WALKS} walks, {reads / n_mb / WALKS:.2f} per MB and "
                  "walk")
            out.append((
                f"pattern_walk[S={S},{tag}]",
                "x264dsp_tpu_torch/csrc/me_walk.cu",
                "none (x264dsp_tpu/encoder/inter_frame.py:349 is plain JAX)",
                lambda c=chain: c(ME.pattern_walk_cuda),
                lambda c=chain: c(ME.pattern_walk_plain), None, 10, 1,
                (4 * reads + WALKS * 24 * n_mb + (WALKS - 1) * 8 * n_mb, 0),
                S))
        return out

    rng = np.random.default_rng(2024)
    cases, p_args, i_args = cases_at(S_MAIN, rng)
    cases += cases_at(1, rng)[0] + band_cases(rng) + walk_cases()

    for (name, src, replaces, kern, plain, lib, reps, preps, work,
         S) in cases:
        got = kern()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        once_ms = (time.perf_counter() - t0) * 1e3
        err = max_err(got, want)
        if lib is not None and max_err(lib(), want) != 0:
            fail(f"the library call for {name} computes another function")
        del got, want
        ms = time_cuda(kern, reps)
        # device_ms is per launch; a walk case's call is WALKS launches
        per_call = WALKS if name.startswith("pattern_walk") else 1
        dev_ms = per_call * device_ms(kern, name.split("[")[0] + "_kernel",
                                      reps, per_call)
        plain_ms = time_cuda(plain, preps) if preps else once_ms
        library_ms = time_cuda(lib, reps) if lib is not None else None
        bound_ms, bound_by = bound(*work)
        # K3, K5a and K5b are bound by their critical path: mb_w + 2 mb_h
        # - 2 MB steps
        sad_n = 4 * work[1]     # the SAD cases' pixel-offset pairs
        per_step = (f"  {1e3 * ms / (mb_w + 2 * mb_h - 2):.3f} us per "
                    f"critical-path step (device "
                    f"{1e3 * dev_ms / (mb_w + 2 * mb_h - 2):.3f})"
                    if name.startswith("deblock")
                    else (f"  (at the probe's rate "
                          f"{sad_n / 4 / rate * 1e3:.3f} ms; int32 "
                          f"formulation {2 * sad_n / INT32_OPS_S * 1e3:.3f}"
                          " ms)")
                    if name.startswith("sad_") else "")
        print(f"kernel {name:22s} max_abs_err {err}  {ms:9.3f} ms  "
              f"(device {dev_ms:.4f} ms)  plain {plain_ms:10.3f} ms  "
              "library "
              + (f"{library_ms:.3f} ms" if lib is not None else "none")
              + f"  bound {bound_ms:.3f} ms ({bound_by})" + per_step)
        if err != 0:
            fail(f"kernel {name} disagrees with its plain version")
        rec.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, streams=S, max_abs_err=err, ms=ms,
                        device_ms=dev_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms))
        if src.endswith("deblock.cu"):
            rec[-1]["ptxas"] = usage[name.split("[")[0] + "_kernel"]

    # the three routes of deblock_frame on the same planes and grids:
    # lanes + K5a + K5b, and one gather + K6 + scatter per diagonal,
    # against K3
    S = S_MAIN
    for tag, args in (("P", p_args), ("I", i_args)):
        want = DB.deblock_frame(*args)
        ms = {None: time_cuda(lambda: DB.deblock_frame(*args), 5)}
        for route in ("wave", "region"):
            err = max_err(DB.deblock_frame(*args, route=route), want)
            if err != 0:
                fail(f"deblock route {route} [{tag}] disagrees with K3")
            ms[route] = time_cuda(
                lambda: DB.deblock_frame(*args, route=route), 2)
        print(f"deblock routes [{tag}], whole frame S={S}: default (K3) "
              f"{ms[None]:.3f} ms, wave (lanes + K5a + K5b) "
              f"{ms['wave']:.3f} ms, region ({mb_w + 2 * mb_h - 2} x gather "
              f"+ K6 + scatter) "
              f"{ms['region']:.3f} ms, max_abs_err 0")
    return rec


def small_clip(w, h, n, seed, sigma=2.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n):
        y = (110 + 60 * np.sin((xx + 2 * t) / 13.0) * np.cos(yy / 17.0)
             + rng.normal(0, sigma, (h, w))).clip(0, 255).astype(np.uint8)
        u = (120 + 30 * np.sin((xx[::2, ::2] + t) / 23.0)).clip(
            0, 255).astype(np.uint8)
        v = (128 + 30 * np.cos((yy[::2, ::2] + t) / 29.0)).clip(
            0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def encode(be, batches, routes=None, after_slot=None):
    """Run stacked (y, u, v) batches through a BatchEncoder; `routes`
    gives each slot's deblock route, `after_slot(t)` runs after slot t's
    step. Returns the per-slot per-stream Annex-B bytes, the per-slot
    deblocked recon planes, as the encoder's own device tensors (kept,
    not copied: no host transfer or sync inside a timed run), and the
    encoder's summary."""
    import torch
    slots, recons = [], []
    for t, item in enumerate(list(batches) + [None]):
        if item is not None and routes is not None:
            be.deblock_route = routes[t]
        out = be.encode_batch(item)
        if item is not None:
            recons.append(be.last_recon)
            if after_slot is not None:
                after_slot(t)
        if out is not None:
            slots.append([b"".join(n.payload for n in nl) for nl in out])
    summary = be.close()
    if be.device.type == "cuda":
        torch.cuda.synchronize()
    return slots, recons, summary


def joined(slots):
    """Per-slot per-stream bytes -> one byte stream per stream."""
    return [b"".join(sl[s] for sl in slots) for s in range(len(slots[0]))]


def n_partitioned(summary) -> int:
    return sum(summary["mb_types"].get(k, 0)
               for k in ("P_16x8", "P_8x16", "P_8x8"))


def card_vs_cpu():
    """Phase 3: identical bytes from the GPU and the CPU BatchEncoder, for
    the main path, faster-1ref and the two rate-controlled settings."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch.tools.mainpath import (abr_esa_param,
                                                  crf_umh_param,
                                                  faster_1ref_param,
                                                  main_path_param,
                                                  split_motion_clip)
    S, n = 2, 6

    def stacked(clips):
        return [tuple(torch.from_numpy(np.stack([clips[s][t][i]
                                                 for s in range(S)]))
                      for i in range(3)) for t in range(n)]
    cpu = torch.device("cpu")
    split = [split_motion_clip(64, 64, cpu, seed) for seed in (11, 13)]
    detail = stacked([small_clip(64, 48, n, 11 + s, sigma)
                      for s, sigma in enumerate((2.0, 8.0))])
    # label, size, parameters, clip, with the deblock routes
    configs = (
        ("main path", 64, 48, main_path_param,
         stacked([small_clip(64, 48, n, 11 + s) for s in range(S)]), True),
        ("faster-1ref", 64, 64, faster_1ref_param,
         stacked([[tuple(p.numpy() for p in f(t)) for t in range(n)]
                  for f in split]), True),
        ("crf30-umh-subme0", 64, 48,
         lambda w, h, qp, keyint: crf_umh_param(w, h, keyint), detail, False),
        ("abr200-esa-subme2-parts", 64, 48,
         lambda w, h, qp, keyint: abr_esa_param(w, h, keyint), detail, False))
    for label, w, h, make, batches, routes in configs:
        out, qps = {}, {}
        runs = (("cuda", None), ("cpu", None))
        if routes:
            runs += (("cuda", "wave"), ("cuda", "region"))
        for dev, route in runs:
            be = xtt.BatchEncoder(make(w, h, 26, 4), S, device=dev)
            qps[dev, route] = []
            slots, _, summary = encode(
                be, batches, routes=[route] * n,
                after_slot=lambda t, b=be, q=qps[dev, route]: q.append(
                    b.last_qps))
            out[dev, route] = joined(slots)
        same = (out["cuda", None] == out["cpu", None]
                and qps["cuda", None] == qps["cpu", None])
        routes_same = all(out[k] == out["cuda", None] for k in out)
        print(f"card vs CPU, {label} {w}x{h} S={S} keyint 4, {n} frames: "
              f"bytes {[len(b) for b in out['cuda', None]]} "
              f"identical={same}"
              + (f", wave and region routes identical={routes_same}"
                 if routes else "")
              + f", partitioned MBs {n_partitioned(summary)}, stream QPs "
              f"per slot {qps['cuda', None]}")
        if not same or not all(out["cpu", None]):
            fail(f"the card's Annex-B bytes differ from the CPU's ({label})")
        if not routes_same:
            fail(f"a deblock route changes the card's bytes ({label})")
    encoder_card_vs_cpu()


def encoder_card_vs_cpu():
    """Phase 3, the Encoder: the scene-cut clip at param_default(), at the
    CQP + CABAC settings with forced types and QPs, and at the live-stream
    CBR cut to 40 kbit/s and a 6 kbit buffer under CABAC and CAVLC; the
    multi-ref clip at 3 references with the JVT lists and noise
    reduction, its corrupt marks and its extreme frame at QP 0, under
    CAVLC (whose overflow re-encode must fire) and CABAC; then the CLI:
    the card against the CPU."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import (ENCODER_FORCED,
                                                  REFS_FORCED, REFS_MARKS,
                                                  MarkingEncoder,
                                                  encode_clip, encode_diff,
                                                  encoder_cbr_param,
                                                  encoder_cqp_param,
                                                  encoder_param,
                                                  encoder_refs_param,
                                                  multiref_clip,
                                                  scene_cut_clip)
    from x264dsp_tpu_torch.encoder.ratecontrol import log2_f32
    # variance AQ's log2 (the JAX package's float32 log2) on the card and
    # on the CPU at every integer energy below 2**23
    e = torch.arange(1, 1 << 23, dtype=torch.float32)
    n_diff = int((log2_f32(e.cuda()).cpu().view(torch.int32)
                  != log2_f32(e).view(torch.int32)).sum())
    print(f"AQ log2_f32, card vs CPU at the {e.numel()} integer energies: "
          f"{n_diff} differ")
    if n_diff:
        fail("AQ's log2 differs between the card and the CPU")
    w, h = 56, 40
    frames = scene_cut_clip(w, h)
    refs_clip = multiref_clip(w, h)

    def cbr(w, h, cabac):
        p = encoder_cbr_param(w, h, 40)
        p.rc.i_vbv_buffer_size = 6
        p.b_cabac = cabac
        return p
    refs = "3 refs + JVT CQM + NR 100, corrupt marks, extreme frame at QP 0"
    for label, make, clip0, forced, marks in (
            ("param_default", encoder_param, frames, {}, {}),
            ("CQP 20 + CABAC + HEX + partitions, forced types and QPs",
             encoder_cqp_param, frames, ENCODER_FORCED, {}),
            ("CBR 40 kbit/s, 6 kbit buffer, HRD, AQ, lookahead 4, CABAC",
             lambda w, h: cbr(w, h, 1), frames, {}, {}),
            ("CBR 40 kbit/s, 6 kbit buffer, HRD, AQ, lookahead 4, CAVLC",
             lambda w, h: cbr(w, h, 0), frames, {}, {}),
            (f"{refs}, CAVLC (overflow re-encode)",
             lambda w, h: encoder_refs_param(w, h, 3, 0), refs_clip,
             REFS_FORCED, REFS_MARKS),
            (f"{refs}, CABAC", lambda w, h: encoder_refs_param(w, h, 3, 1),
             refs_clip, REFS_FORCED, REFS_MARKS)):
        runs, encs = {}, {}
        for dev in ("cuda", "cpu"):
            clip = ([[torch.as_tensor(a, device=dev) for a in f]
                     for f in clip0] if dev == "cuda" else clip0)
            encs[dev] = MarkingEncoder(xtt.Encoder(make(w, h), device=dev),
                                       marks)
            runs[dev] = encode_clip(encs[dev], clip, forced)
        diff = encode_diff(runs["cuda"], runs["cpu"])
        pics = runs["cpu"]["pics"]
        fillers = sum(t == P.NAL_FILLER for nl in runs["cpu"]["nals"]
                      for t, _ in nl)
        last = encs["cuda"].frames[-1]
        print(f"card vs CPU, Encoder {label} {w}x{h}, {len(clip0)} frames: "
              f"types {[po.i_frame_type for po in pics]} QPs "
              f"{[po.i_frame_qp for po in pics]} bytes "
              f"{sum(len(b) for nl in runs['cpu']['nals'] for _, b in nl)} "
              f"waiting {runs['cpu']['waiting']} filler NALs {fillers} "
              f"ref histogram {runs['cpu']['summary'].get('ref_histogram')} "
              f"last frame's overflow re-encodes {last['overflow']} "
              f"identical={diff is None}")
        if diff is not None or len(pics) != len(clip0):
            fail(f"the card's Encoder differs from the CPU's ({label}): "
                 f"{diff}")
        cavlc = not make(w, h).b_cabac
        if marks and (bool(last["overflow"]) != cavlc or not sum(
                runs["cpu"]["summary"]["ref_histogram"][1:])):
            fail(f"{label}: no overflow re-encode under CAVLC (or one under "
                 "CABAC), or no MB took a reference past the nearest")
    slices_card_vs_cpu()
    cli_card_vs_cpu(frames)
    mesh_card_vs_cpu()


def slices_card_vs_cpu():
    """Phase 3, the Encoder's slices and intra refresh on the 64x96 slices
    clip, every case of mainpath.SLICE_CASES (CQP 26): the card's
    Encoder, profiled (a device sync at each stage), against the CPU's,
    one slice NAL per band, and the band encodes' kernels launched."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import (SLICE_CASES,
                                                  MarkingEncoder,
                                                  encode_clip, encode_diff,
                                                  encoder_slices_param,
                                                  slices_clip)
    w, h = 64, 96
    clip0 = slices_clip(w, h)
    for name in SLICE_CASES:
        runs, bands = {}, {}
        for dev in ("cuda", "cpu"):
            clip = ([[torch.as_tensor(a, device=dev) for a in f]
                     for f in clip0] if dev == "cuda" else clip0)
            xtt.reset_kernel_launches()
            enc = MarkingEncoder(xtt.Encoder(
                encoder_slices_param(w, h, name), device=dev,
                profile=dev == "cuda"), {})
            runs[dev] = encode_clip(enc, clip)
            bands[dev] = [f["slices"] for f in enc.frames]
            if dev == "cuda":
                launches = xtt.kernel_launches()
        diff = encode_diff(runs["cuda"], runs["cpu"])
        if bands["cuda"] != bands["cpu"]:
            diff = diff or "slice bands"
        bands = bands["cpu"]
        pics = runs["cpu"]["pics"]
        slices = [[b for t, b in nl if t in (P.NAL_SLICE, P.NAL_SLICE_IDR)]
                  for nl in runs["cpu"]["nals"]]
        need = ("sad_surface16", "pattern_walk", "luma_windows",
                "chroma_windows", "deblock")
        if name == "refs2":
            need += ("sad_surfaces_8x8",)
        print(f"card vs CPU, Encoder slices {name} {w}x{h}, {len(clip0)} "
              f"frames: types {[po.i_frame_type for po in pics]} slice NALs "
              f"{[len(s) for s in slices]} bands {bands[0]} (frame 0) "
              f"largest slice NAL {max(len(b) for s in slices for b in s)} "
              f"bytes, launches {[launches[k] for k in need]} of {need}, "
              f"identical={diff is None}")
        if (diff is not None or len(pics) != len(clip0)
                or [len(s) for s in slices] != [len(b) for b in bands]):
            fail(f"the card's Encoder differs from the CPU's (slices "
                 f"{name}): {diff}")
        if any(launches[k] <= 0 for k in need):
            fail(f"slices {name}: a kernel of the band encode never "
                 f"launched: {need} {[launches[k] for k in need]}")
        if name == "max-size400" and (
                max(len(b) for s in slices for b in s) > 400
                or len(bands[0]) <= 3):
            fail("slices max-size400: a slice NAL passes 400 bytes, or the "
                 "I frame was not split")
        if name == "intra-refresh" and pics[-1].i_frame_type != P.TYPE_P:
            fail("slices intra-refresh: keyint made an IDR past frame 0")


def cli_card_vs_cpu(frames):
    """Phase 3, the CLI (x264dsp_tpu_torch/cli.py): a 56x40 .yuv through
    --device cuda and --device cpu must give the same .264 bytes."""
    from x264dsp_tpu_torch import cli
    from x264dsp_tpu_torch.utils.yuv import write_yuv
    work = ROOT / "build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "clip_56x40.yuv"
    write_yuv(str(src), frames)
    out = {}
    for dev in ("cuda", "cpu"):
        dst = work / f"cli_{dev}.264"
        if cli.main([str(src), str(dst), "--device", dev]) != 0:
            fail(f"the CLI failed on --device {dev}")
        out[dev] = dst.read_bytes()
    print(f"card vs CPU, CLI 56x40, {len(frames)} frames, param_default: "
          f"{len(out['cuda'])} bytes, identical={out['cuda'] == out['cpu']}")
    if out["cuda"] != out["cpu"] or not out["cpu"]:
        fail("the CLI's .264 on the card differs from the CPU's")


def mesh_devices() -> list:
    """Every card torch sees when there are two or more, else cuda:0
    twice (logical shards of one card)."""
    import torch
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0"] * 2


def mesh_card_vs_cpu():
    """Phase 3, the stream mesh (x264dsp_tpu_torch/parallel/mesh.py): the
    I step and the P pipeline (ESA) of 4 streams at 64x48 over a
    two-entry mesh of the card against a two-entry CPU mesh: identical
    outputs, every key and the three new reference planes."""
    import torch
    from x264dsp_tpu_torch.ops import mc as MC
    from x264dsp_tpu_torch.parallel import dryrun as D
    from x264dsp_tpu_torch.parallel import mesh as M
    w, h, S = 64, 48, 4
    clips = [small_clip(w, h, 2, 21 + s) for s in range(S)]
    frames = [tuple(np.stack([clips[s][t][i] for s in range(S)])
                    for i in range(3)) for t in (0, 1)]
    devs = mesh_devices()[:2]
    out = {}
    for label, mesh_devs in (("card", devs), ("cpu", ["cpu"] * 2)):
        mesh = M.make_stream_mesh(mesh_devs)
        ts = M.shard_streams(mesh, *(torch.from_numpy(a)
                                     for a in frames[0] + frames[1]))
        i_out = M.encode_i_frames_batched(*ts[:3], D.QP, D.QPC, D.LAMBDA,
                                          w // 16, h // 16, True, True)
        refs = [M.map_streams(f, i_out[k]) for f, k in (
            (MC.make_ref_planes, "recon_y"), (MC.pad_chroma, "recon_u"),
            (MC.pad_chroma, "recon_v"))]
        p_out, new_refs = M.encode_p_pipeline_batched(
            *ts[3:], *refs, D.QP, D.QPC, D.LAMBDA, w // 16, h // 16,
            D.ME_RANGE, D.MV_RANGE, True)
        out[label] = {**{f"I {k}": D.host(v) for k, v in i_out.items()},
                      **{f"P {k}": D.host(v) for k, v in p_out.items()},
                      **{f"ref{i}": D.host(r) for i, r in enumerate(new_refs)}}
    differ = [k for k in out["cpu"] if k not in out["card"]
              or not np.array_equal(out["card"][k], out["cpu"][k])]
    print(f"card vs CPU, stream mesh {w}x{h} S={S} over {devs} vs 2 x "
          f"cpu: I step + P pipeline (ESA), {len(out['cpu'])} outputs, "
          f"identical={not differ}")
    if differ:
        fail(f"the card's mesh differs from the CPU's: {differ}")


def psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def drive(label, param, batches, path_kernels, routes=None,
          profile=False, after_slot=None, keep_syntax=False):
    """Drive one path through the BatchEncoder on the card, unprofiled
    unless `profile`: the launch counters are set to 0 just before and
    read just after. `after_slot(be, t)` runs after slot t's step, outside
    the timed wall (keep_syntax: the encoder keeps each slot's syntax for
    it). Fails unless every kernel of the path launched, every
    stream is non-empty and the worst luma PSNR is at least 30 dB. Returns
    the launches, the encoder's summary, the per-slot bytes and the
    encoder."""
    import torch
    import x264dsp_tpu_torch as xtt
    S = batches[0][0].shape[0]
    torch.cuda.synchronize()
    xtt.reset_kernel_launches()
    be = xtt.BatchEncoder(param, S, profile=profile)
    be.keep_syntax = keep_syntax
    checks = [0.0]

    def timed_check(t):
        t1 = time.perf_counter()
        after_slot(be, t)
        checks[0] += time.perf_counter() - t1
    t0 = time.perf_counter()
    slots, recons, summary = encode(
        be, batches, routes=routes,
        after_slot=timed_check if after_slot is not None else None)
    wall = time.perf_counter() - t0 - checks[0]
    launches = xtt.kernel_launches()
    streams = joined(slots)
    print(f"{label} {W}x{H} S={S}: 1 I + {len(batches) - 1} P slots "
          f"in {wall:.3f} s = {S * len(batches) / wall:.3f} fps"
          + (" (profiled: a device sync at each stage)" if profile else "")
          + f" (bytes/stream {[len(b) for b in streams]})")
    print(f"kernel launches in {label}: {launches}")
    print(f"{label} MB types: {summary['mb_types']}")
    missing = [k for k in path_kernels if launches[k] <= 0]
    if missing:
        fail(f"kernels of {label} never launched: {missing}")
    # output check: every stream coded, recon close to the source
    worst = 99.0
    for t, (ry, _, _) in enumerate(recons):
        ry, src = ry.cpu().numpy(), batches[t][0].cpu().numpy()
        for s in range(S):
            worst = min(worst, psnr(ry[s], src[s]))
    print(f"{label} recon: worst luma PSNR {worst:.2f} dB over "
          f"{len(recons)} slots x {S} streams")
    if worst < 30.0 or min(len(b) for b in streams) == 0:
        fail(f"{label} output is wrong (empty stream or PSNR < 30 dB)")
    return launches, summary, slots, be


def main_path(n_p: int = 4):
    """Phase 4: the 1080p 8-stream main path through the BatchEncoder."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch.tools.mainpath import (main_path_param,
                                                  stacked_slot, synth_clip)
    frame = synth_clip(W, H, torch.device("cuda"))
    batches = [stacked_slot(frame, t, S_MAIN) for t in range(1 + n_p)]
    param = main_path_param(W, H, QP, KEYINT)
    launches, _, slots, _ = drive("main path", param, batches,
                                  ("sad_surface16", "pattern_walk",
                                   "luma_windows", "chroma_windows",
                                   "deblock"))

    # the same slots once more with stage timing (synchronizes the device
    # at each stage); between the steps, outside the timed stages, the I
    # slot's and the first P slot's syntax is pulled once and every
    # stream's device payload is held to the host C++ writers
    from x264dsp_tpu_torch.tools.mainpath import payload_vs_writers
    be = xtt.BatchEncoder(param, S_MAIN, profile=True)
    be.keep_syntax = True

    def check(t):
        if t < 2:
            bits = payload_vs_writers(be)
            print(f"device payload == host C++ writers, {'IP'[t]} slot, "
                  f"{S_MAIN} streams: bits {bits}")
        else:
            be.keep_syntax, be.last_slot = False, None
    profiled, _, _ = encode(be, batches, after_slot=check)
    if profiled != slots:
        fail("the profiled main-path run wrote other bytes")
    print_stages("", be, ("encode", "cavlc", "deblock", "ref_planes",
                          "pull"))
    return launches, slots


def print_stages(label, be, stages):
    """The mean per-stage ms of a profiled BatchEncoder's I and P slots."""
    for kind, name in ((2, "I"), (0, "P")):
        rows = [tm for st, tm in be.slot_times if st == kind]
        if not rows:
            continue
        avg = {k: 1000 * sum(r.get(k, 0.0) for r in rows) / len(rows)
               for k in stages}
        total = sum(avg.values())
        print(f"{label}{name} slot ms (mean of {len(rows)}): "
              + " ".join(f"{k} {v:.2f}" for k, v in avg.items())
              + f" | total {total:.2f}")


def faster_path(n_p: int = 2):
    """Phase 5: faster-1ref (HEX, subme 4, partitions) at 1080p, 8
    streams, on the split-motion clip, unprofiled (its stage split comes
    from tools/profile_slot.py)."""
    import torch
    from x264dsp_tpu_torch.tools.mainpath import (faster_1ref_param,
                                                  split_motion_clip,
                                                  stacked_slot)
    frame = split_motion_clip(W, H, torch.device("cuda"))
    batches = [stacked_slot(frame, t, S_MAIN) for t in range(1 + n_p)]
    launches, summary, _, _ = drive(
        "faster-1ref", faster_1ref_param(W, H, QP, KEYINT), batches,
        ("sad_surfaces_8x8", "pattern_walk", "luma_windows",
         "chroma_windows", "deblock"))
    if n_partitioned(summary) <= 0:
        fail("faster-1ref coded no 16x8, 8x16 or 8x8 MB")
    return launches


def routes_path(main_slots):
    """Phase 6: the main-path clip with the I slot and the first P slot on
    the wave route, the second P slot on the region route and the third on
    the default; the bytes must be those of phase 4's first four slots."""
    import torch
    from x264dsp_tpu_torch.tools.mainpath import (main_path_param,
                                                  stacked_slot, synth_clip)
    routes = ("wave", "wave", "region", None)
    frame = synth_clip(W, H, torch.device("cuda"))
    batches = [stacked_slot(frame, t, S_MAIN) for t in range(len(routes))]
    launches, _, slots, _ = drive(
        "deblock routes", main_path_param(W, H, QP, KEYINT), batches,
        ("deblock_wave_luma", "deblock_wave_chroma", "filter_regions",
         "deblock", "pattern_walk"), routes=routes)
    if slots != main_slots[:len(routes)]:
        fail("the wave / region deblock routes changed the main path's "
             "bytes")
    n_diag = W // 16 + 2 * (H // 16) - 2
    want = {"deblock_wave_luma": 2, "deblock_wave_chroma": 2,
            "filter_regions": n_diag, "deblock": 1}
    got = {k: launches[k] for k in want}
    print(f"deblock routes: bytes equal the main path's first "
          f"{len(routes)} slots; launches {got}")
    if got != want:
        fail(f"deblock route launches {got}, expected {want}")
    return launches


def v2_path(n_p: int = 2):
    """Phase 7: per-stream CRF 23 with the ESA search at 1080p, 8 streams
    whose clips differ in detail, profiled; every slot's device payloads
    are held to the host C++ writers with each stream's own slice header
    and QP. The QPs of the I and the first P slot come from the rate
    controls' start values (each learns a slot's size one slot late), so
    the streams' QPs part from the second P slot on."""
    import torch
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import (crf_param, detail_clips,
                                                  payload_vs_writers,
                                                  stacked_slot)
    frames = detail_clips(W, H, torch.device("cuda"), S_MAIN)
    batches = [stacked_slot(frames, t, S_MAIN) for t in range(1 + n_p)]
    param = crf_param(W, H, 23.0, KEYINT)
    param.analyse.i_me_method = P.ME_ESA

    qps = []

    def hold(be, t):
        qps.append(be.last_qps)
        bits = payload_vs_writers(be)
        print(f"v2: device payload == host C++ writers, slot {t} "
              f"({'I' if t == 0 else 'P'}), {S_MAIN} streams, QPs "
              f"{be.last_slot['qps']}: bits {bits}")
    launches, _, _, be = drive(
        "v2 (CRF 23, ESA)", param, batches,
        ("sad_surfaces_8x8", "luma_windows", "chroma_windows", "deblock"),
        profile=True, after_slot=hold, keep_syntax=True)
    for t, q in enumerate(qps):
        print(f"v2 slot {t} ({'I' if t == 0 else 'P'}) stream QPs {q}")
    if not any(len(set(q)) > 1 for q in qps):
        fail("v2: every stream got the same QP in every slot")
    print_stages("v2 ", be, ("lowres", "encode", "cavlc", "deblock",
                             "ref_planes", "pull"))
    return launches


class FrameClock:
    """An Encoder whose encode() calls are timed: ms holds each call's
    wall in ms (a call returns after pulling its frame's payload and
    recon)."""

    def __init__(self, enc):
        self.enc, self.ms = enc, []

    def headers(self):
        return self.enc.headers()

    def encode(self, pic):
        t = time.perf_counter()
        out = self.enc.encode(pic)
        self.ms.append((time.perf_counter() - t) * 1e3)
        return out

    def close(self):
        return self.enc.close()


def encoder_path(n_p: int = 3):
    """Phase 8: the single-stream Encoder at param_default() at 1920x1080,
    one I and n_p P frames, unprofiled, and the CAVLC twin of its first
    two frames."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import (cabac_twin, encode_clip,
                                                  encoder_param, synth_clip)
    h = 1080
    frame = synth_clip(W, H, torch.device("cuda"))
    frames = [[a[:h >> (i > 0)] for i, a in enumerate(frame(1.0 + t))]
              for t in range(1 + n_p)]
    param = encoder_param(W, h)
    torch.cuda.synchronize()
    xtt.reset_kernel_launches()
    t0 = time.perf_counter()
    enc = FrameClock(xtt.Encoder(param))
    run = encode_clip(enc, frames)
    wall = time.perf_counter() - t0
    launches = xtt.kernel_launches()
    pics = run["pics"]
    sizes = [sum(len(b) for _, b in nl) for nl in run["nals"]]
    print(f"encoder {W}x{h} param_default (CRF 28, CABAC): 1 I + {n_p} P "
          f"frames in {wall:.3f} s = {len(frames) / wall:.3f} fps; types "
          f"{[po.i_frame_type for po in pics]} QPs "
          f"{[po.i_frame_qp for po in pics]} bytes {sizes} frame walls ms "
          f"{[round(m, 2) for m in enc.ms[:len(frames)]]}")
    print(f"kernel launches in encoder: {launches}")
    missing = [k for k in ("sad_surface16", "pattern_walk", "luma_windows",
                           "chroma_windows", "deblock") if launches[k] <= 0]
    if missing:
        fail(f"kernels of the encoder never launched: {missing}")
    worst = min(psnr(po.y, f[0].cpu().numpy()) for po, f in zip(pics, frames))
    print(f"encoder recon: worst luma PSNR {worst:.2f} dB over "
          f"{len(frames)} frames")
    if ([po.i_frame_type for po in pics] != [P.TYPE_IDR] + [P.TYPE_P] * n_p
            or worst < 30.0 or min(sizes) == 0):
        fail("encoder output is wrong (frame types, PSNR < 30 dB or an "
             "empty frame)")

    # the CAVLC twin of frames 0 and 1, each forced to the CRF run's QP
    # (mainpath.cabac_twin): the analysis does not read the entropy mode,
    # so its type, QP and recon are the CABAC run's, its device payload is
    # the host C++ writers', and its syntax with the CABAC-only keys,
    # written by the C++ CABAC writer, gives the run's slice NALs. The twin
    # keeps CRF: a CQP stream's QPs are clipped to qp_constant -3..+3
    # (validate_parameters), narrower than the CRF run's I and P QPs may
    # lie
    kept = []
    try:
        bits = cabac_twin(param, run, frames, 2, keep=kept)
    except RuntimeError as e:
        fail(f"encoder twin: {e}")
    print(f"encoder twin (CAVLC) frames 0-1 at QPs "
          f"{[po.i_frame_qp for po in pics[:2]]}: type, QP and recon == "
          f"CABAC run's; device payload == host C++ writers (bits {bits}); "
          f"C++ CABAC writer on its syntax == CABAC run's slice NALs")
    cabac_front_half(kept, W, h)
    return launches


def cabac_front_half(kept, w, h, reps: int = 5):
    """Phase 8, the device CABAC front half (entropy/cabac_device.py) on
    the twin's frames: residual_ops_frame on the card (cap_ops 1 << 22)
    must equal the CPU's, and the C++ CABAC writer must write the same
    bytes and MB counts with the op stream as without it. Prints the
    card's ms (CUDA events) and peak memory, the pull of the ops, and the
    writer's host ms both ways."""
    import torch
    from x264dsp_tpu_torch.entropy import native
    from x264dsp_tpu_torch.entropy.cabac_device import residual_ops_frame
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    for t, k in enumerate(kept):
        syn, is_p = k["syn"], k["is_p"]
        dev = syn["luma_levels"].device
        dc = torch.zeros((mb_h, mb_w, 16), dtype=torch.int32, device=dev)
        args = [syn[n][0] if n in syn else dc for n in (
            "luma_levels", "luma_dc_levels", "chroma_dc_levels",
            "chroma_ac_levels")]
        args.append(torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
                    if is_p else syn["mb_type"][0] == 0)

        def front():
            return residual_ops_frame(*args, mb_h, mb_w, 1 << 22)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_cuda(front, reps)
        peak = torch.cuda.max_memory_allocated()
        ops, off, ov = front()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = int(off[-1])
        ops_np, off_np = ops[:total].cpu().numpy(), off.cpu().numpy()
        pull_ms = (time.perf_counter() - t0) * 1e3
        cpu = residual_ops_frame(*(a.cpu() for a in args), mb_h, mb_w,
                                 1 << 22)
        if not all(torch.equal(a.cpu(), b) for a, b in zip((ops, off, ov),
                                                           cpu)):
            fail(f"CABAC front half, frame {t}: the card's ops differ from "
                 "the CPU's")
        if bool(ov):
            fail(f"CABAC front half, frame {t}: op stream overflow")
        qp_mb = np.full((mb_h, mb_w), k["qp"], np.int32)

        def write(**kw):
            return native.write_slice_cabac(bytes([0x40]), mb_w, mb_h,
                                            k["qp"], t, is_p, k["host"],
                                            qp_mb=qp_mb, **kw)

        def host_ms(**kw):
            t0 = time.perf_counter()
            for _ in range(reps):
                write(**kw)
            return (time.perf_counter() - t0) / reps * 1e3
        with_ops = {"res_ops": ops_np, "res_off": off_np}
        want, got = write(), write(**with_ops)
        full_ms, ops_ms = host_ms(), host_ms(**with_ops)
        same = got[0] == want[0] and np.array_equal(got[1], want[1])
        print(f"CABAC front half, frame {t} ({'IP'[is_p]}, QP {k['qp']}): "
              f"residual_ops_frame {ms:.3f} ms on the card (peak "
              f"{peak / 2**20:.0f} MiB), {total} residual bins == CPU's; "
              f"ops pull {pull_ms:.2f} ms; C++ CABAC writer {full_ms:.2f} "
              f"ms, with the ops {ops_ms:.2f} ms ({full_ms / ops_ms:.2f}x); "
              f"{len(want[0])} bytes, identical={same}")
        if not same:
            fail(f"CABAC front half, frame {t}: the writer's bytes with the "
                 "ops differ from its own binarization's")


def encoder_cbr_path(n_slate: int = 4, n_clip: int = 5):
    """Phase 9: the Encoder as a live stream's CBR (mainpath.
    encoder_cbr_param: 6000 kbit/s, NAL HRD, variance AQ, lookahead 4) at
    1920x1080: n_slate frames of a flat slate (an IDR, then P frames that
    spend next to nothing, so the CPB overflows into filler), then n_clip
    P frames of phase 4's clip (the cut inside keyint_min), then the
    drain; unprofiled."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import encoder_cbr_param, synth_clip
    h = 1080
    dev = torch.device("cuda")
    frame = synth_clip(W, H, dev)
    slate = [torch.full((h >> (i > 0), W >> (i > 0)), 128, dtype=torch.uint8,
                        device=dev) for i in range(3)]
    frames = [slate] * n_slate + [
        [a[:h >> (i > 0)] for i, a in enumerate(frame(1.0 + t))]
        for t in range(n_clip)]
    param = encoder_cbr_param(W, h)

    torch.cuda.synchronize()
    xtt.reset_kernel_launches()
    t0 = time.perf_counter()
    # encode and drain: each frame's (NALs, pic_out, last_frame), and the
    # calls that returned nothing
    enc = xtt.Encoder(param)
    out, waiting = [], 0

    def keep(nals, po):
        if po is not None:
            out.append((nals, po, enc._core.last_frame))
        return po is not None
    for t, f in enumerate(frames):
        waiting += not keep(*enc.encode(xtt.Picture.from_planes(*f, pts=t)))
    while keep(*enc.encode(None)):
        pass
    enc.close()
    wall = time.perf_counter() - t0
    launches = xtt.kernel_launches()
    print(f"encoder-cbr {W}x{h} CBR 6000 kbit/s, NAL HRD, AQ, lookahead 4: "
          f"{n_slate} slate + {n_clip} clip frames (1 I + "
          f"{n_slate + n_clip - 1} P) in {wall:.3f} s = "
          f"{len(frames) / wall:.3f} fps; {waiting} calls waited, "
          f"{len(out)} frames out")
    for t, (nals, po, rec) in enumerate(out):
        size = sum(len(n.payload) for n in nals)
        print(f"encoder-cbr frame {t}: type {po.i_frame_type} QP "
              f"{po.i_frame_qp} (per-MB {rec['qp_min']}..{rec['qp_max']}) "
              f"bytes {size} filler {rec['filler']} device encodes "
              f"{rec['encodes']} (row VBV {rec['row_vbv']}, re-encodes "
              f"{rec['reencodes']})"
              + (f" buffering period delay {rec['bp'][0]} offset "
                 f"{rec['bp'][1]}" if rec["bp"] else ""))
    print(f"kernel launches in encoder-cbr: {launches}")
    missing = [k for k in ("sad_surface16", "pattern_walk", "luma_windows",
                           "chroma_windows", "deblock") if launches[k] <= 0]
    if missing:
        fail(f"kernels of encoder-cbr never launched: {missing}")
    worst = min(psnr(po.y, f[0].cpu().numpy())
                for (_, po, _), f in zip(out, frames))
    print(f"encoder-cbr recon: worst luma PSNR {worst:.2f} dB over "
          f"{len(out)} frames")
    types = [po.i_frame_type for _, po, _ in out]
    fillers = sum(n.i_type == P.NAL_FILLER for nals, _, _ in out
                  for n in nals)
    if (types != [P.TYPE_IDR] + [P.TYPE_P] * (len(frames) - 1)
            or worst < 30.0
            or waiting != min(param.rc.i_lookahead, len(frames))
            or [po.i_pts for _, po, _ in out] != list(range(len(frames)))):
        fail("encoder-cbr output is wrong (frame types, order, the queue's "
             "delay or PSNR < 30 dB)")
    if not any(rec["qp_max"] > rec["qp_min"] for _, _, rec in out):
        fail("encoder-cbr: AQ left every frame's per-MB QPs flat")
    if not fillers or out[0][2]["bp"] is None:
        fail("encoder-cbr wrote no filler NAL or no buffering-period SEI")
    return launches


def encoder_refs_path(n_p: int = 4):
    """Phase 10: the Encoder at 1920x1080 with x264 --preset medium's three
    references, the JVT scaling lists, noise reduction 100 and CAVLC
    (mainpath.encoder_refs_param), one I and n_p P frames of phase 4's
    clip cut to 1080 rows as CUDA tensors, the newest reference marked
    corrupt before the last frame (so that its list skips it and its
    header reorders), unprofiled. The first P frame has one reference
    (K1), the others two or three (K4, the references on the stream
    axis)."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import (MarkingEncoder,
                                                  encoder_refs_param,
                                                  synth_clip)
    h = 1080
    frame = synth_clip(W, H, torch.device("cuda"))
    frames = [[a[:h >> (i > 0)] for i, a in enumerate(frame(1.0 + t))]
              for t in range(1 + n_p)]
    param = encoder_refs_param(W, h, 3)
    torch.cuda.synchronize()
    xtt.reset_kernel_launches()
    t0 = time.perf_counter()
    enc = MarkingEncoder(xtt.Encoder(param), {n_p: n_p - 1})
    out, ms = [], []
    for t, f in enumerate(frames):
        t1 = time.perf_counter()
        out.append(enc.encode(xtt.Picture.from_planes(*f, pts=t)))
        # encode() returns after pulling the frame's payload and recon
        ms.append((time.perf_counter() - t1) * 1e3)
    summary = enc.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = xtt.kernel_launches()
    print(f"encoder-refs {W}x{h} 3 refs + JVT CQM + NR 100 + CAVLC: 1 I + "
          f"{n_p} P frames in {wall:.3f} s = {len(frames) / wall:.3f} fps")
    for t, ((nals, po), rec) in enumerate(zip(out, enc.frames)):
        print(f"encoder-refs frame {t}: type {po.i_frame_type} QP "
              f"{po.i_frame_qp} bytes {sum(len(n.payload) for n in nals)} "
              f"active refs {rec['n_ref']} reordered {rec['reorder']} "
              f"device encodes {rec['encodes']} wall {ms[t]:.2f} ms")
    print(f"encoder-refs ref histogram {summary.get('ref_histogram')}")
    print(f"kernel launches in encoder-refs: {launches}")
    missing = [k for k in ("sad_surface16", "sad_surfaces_8x8",
                           "pattern_walk", "luma_windows", "chroma_windows",
                           "deblock")
               if launches[k] <= 0]
    if missing:
        fail(f"kernels of encoder-refs never launched: {missing}")
    worst = min(psnr(po.y, f[0].cpu().numpy())
                for (_, po), f in zip(out, frames))
    print(f"encoder-refs recon: worst luma PSNR {worst:.2f} dB over "
          f"{len(out)} frames")
    n_refs = [rec["n_ref"] for rec in enc.frames]
    if ([po.i_frame_type for _, po in out]
            != [P.TYPE_IDR] + [P.TYPE_P] * n_p or worst < 30.0
            or n_refs[1:] != [1, 2] + [3] * (n_p - 3) + [2]
            or not enc.frames[-1]["reorder"]):
        fail("encoder-refs output is wrong (frame types, active reference "
             "counts, the reordered last frame or PSNR < 30 dB)")
    return launches


def encoder_slices_path(n_p: int = 2):
    """Phase 11: the Encoder at param_default() with 4 slices per frame at
    1920x1080, one I and n_p P frames of phase 8's frames as CUDA tensors,
    unprofiled: 4 bands of 17 MB rows, each band group one frame-step
    call (S = 4), the assembled frame deblocked by K3 across the slice
    edges and each band written by the C++ CABAC writer."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.tools.mainpath import (MarkingEncoder,
                                                  encode_clip, encoder_param,
                                                  synth_clip)
    h = 1080
    frame = synth_clip(W, H, torch.device("cuda"))
    frames = [[a[:h >> (i > 0)] for i, a in enumerate(frame(1.0 + t))]
              for t in range(1 + n_p)]
    param = encoder_param(W, h)
    param.i_slice_count = 4
    torch.cuda.synchronize()
    xtt.reset_kernel_launches()
    t0 = time.perf_counter()
    enc = FrameClock(MarkingEncoder(xtt.Encoder(param), {}))
    run = encode_clip(enc, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = xtt.kernel_launches()
    pics, recs = run["pics"], enc.enc.frames
    print(f"encoder-slices {W}x{h} param_default (CRF 28, CABAC), 4 slices: "
          f"1 I + {n_p} P frames in {wall:.3f} s = "
          f"{len(frames) / wall:.3f} fps")
    n_slices = [sum(t in (P.NAL_SLICE, P.NAL_SLICE_IDR) for t, _ in nl)
                for nl in run["nals"]]
    for t, (nl, po, rec) in enumerate(zip(run["nals"], pics, recs)):
        print(f"encoder-slices frame {t}: type {po.i_frame_type} QP "
              f"{po.i_frame_qp} bytes {sum(len(b) for _, b in nl)} slice "
              f"NALs {n_slices[t]} bands {rec['slices']} device encodes "
              f"{rec['encodes']} wall {enc.ms[t]:.2f} ms")
    print(f"kernel launches in encoder-slices: {launches}")
    missing = [k for k in ("sad_surface16", "pattern_walk", "luma_windows",
                           "chroma_windows", "deblock") if launches[k] <= 0]
    if missing:
        fail(f"kernels of encoder-slices never launched: {missing}")
    worst = min(psnr(po.y, f[0].cpu().numpy()) for po, f in zip(pics, frames))
    print(f"encoder-slices recon: worst luma PSNR {worst:.2f} dB over "
          f"{len(pics)} frames")
    bands = [(0, 17), (17, 34), (34, 51), (51, 68)]
    if ([po.i_frame_type for po in pics] != [P.TYPE_IDR] + [P.TYPE_P] * n_p
            or worst < 30.0 or n_slices != [4] * len(frames)
            or any(rec["slices"] != bands for rec in recs)):
        fail("encoder-slices output is wrong (frame types, slices per "
             "frame, bands or PSNR < 30 dB)")
    return launches


def multichip_path():
    """Phase 12: the stream mesh, on every card torch sees if there are
    two or more, else on cuda:0 twice (logical shards of one card). (a)
    dryrun_multichip at QCIF with its byte-identity check; (b) the P
    pipeline (ESA) at 1920x1088, S = 8, on phase 4's clip: frame 1 against
    the reference planes of frame 0's source, sharded over the mesh and
    unsharded on cuda:0; every output and the three new reference planes
    must be equal. K4, K2a, K2b and K3 must launch in (b)'s sharded run."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch.ops import mc as MC
    from x264dsp_tpu_torch.parallel import dryrun as D
    from x264dsp_tpu_torch.parallel import mesh as M
    from x264dsp_tpu_torch.tools.mainpath import stacked_slot, synth_clip
    devs = mesh_devices()
    label = (f"{len(devs)} cards" if len(set(devs)) > 1
             else "cuda:0 twice (logical shards of one card)")
    torch.cuda.synchronize()
    xtt.reset_kernel_launches()
    t0 = time.perf_counter()
    try:
        res = D.dryrun_multichip(devices=devs)
    except RuntimeError as e:
        fail(str(e))
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches_a = xtt.kernel_launches()
    print(f"multichip (a) dryrun_multichip on {label}: {res} in "
          f"{wall_a:.3f} s; launches {launches_a}")

    frame = synth_clip(W, H, torch.device("cuda"))
    f0, f1 = (stacked_slot(frame, t, S_MAIN) for t in (0, 1))
    args = f1 + (MC.make_ref_planes(f0[0]), MC.pad_chroma(f0[1]),
                 MC.pad_chroma(f0[2]))
    step = (D.QP, D.QPC, D.LAMBDA, W // 16, H // 16, D.ME_RANGE,
            D.MV_RANGE, True)
    mesh = M.make_stream_mesh(devs)
    torch.cuda.synchronize()
    xtt.reset_kernel_launches()
    t0 = time.perf_counter()
    sharded = M.encode_p_pipeline_batched(*M.shard_streams(mesh, *args),
                                          *step)
    torch.cuda.synchronize()
    wall_sh = time.perf_counter() - t0
    launches = xtt.kernel_launches()
    t0 = time.perf_counter()
    single = M.encode_p_pipeline_batched(*args, *step)
    torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t0
    pairs = [(f"out {k}", sharded[0][k], single[0][k]) for k in single[0]]
    pairs += [(f"ref {i}", a, b)
              for i, (a, b) in enumerate(zip(sharded[1], single[1]))]
    differ = [n for n, a, b in pairs
              if not torch.equal(a.gather("cuda:0"), b)]
    worst = min(psnr(single[0]["recon_y"][s].cpu().numpy(),
                     f1[0][s].cpu().numpy()) for s in range(S_MAIN))
    print(f"multichip (b) P pipeline (ESA) {W}x{H} S={S_MAIN} on {label}: "
          f"sharded {wall_sh:.3f} s, unsharded on cuda:0 {wall_1:.3f} s; "
          f"{len(pairs)} outputs identical={not differ}; worst luma PSNR "
          f"{worst:.2f} dB; launches (sharded) {launches}")
    if differ:
        fail(f"multichip: sharded outputs differ from unsharded: {differ}")
    missing = [k for k in ("sad_surfaces_8x8", "luma_windows",
                           "chroma_windows", "deblock") if launches[k] <= 0]
    if missing:
        fail(f"kernels of the multichip path never launched: {missing}")
    if worst < 30.0:
        fail("multichip output is wrong (PSNR < 30 dB)")
    return launches


def main() -> None:
    sys.path.insert(0, str(ROOT))
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    try:
        import x264dsp_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}: {e}")
    if "jax" in sys.modules:
        fail("the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}

    def phase(n, fn, *args):
        """Run phase n and print its wall, the host's clock."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[n] = time.perf_counter() - t0
        print(f"phase {n} ({fn.__name__}) wall {walls[n]:.1f} s")
        return out
    phase(1, setup)
    kernels = phase(2, kernel_checks)
    phase(3, card_vs_cpu)
    launches, main_slots = phase(4, main_path)
    # K4 runs only on the partition path, K5a / K5b / K6 only on their
    # deblock routes: their counts come from phases 5 and 6
    launches["sad_surfaces_8x8"] = phase(5, faster_path)["sad_surfaces_8x8"]
    routed = phase(6, routes_path, main_slots)
    for k in ("deblock_wave_luma", "deblock_wave_chroma", "filter_regions"):
        launches[k] = routed[k]
    phase(7, v2_path)
    # the S = 1 records are held to phase 8's launches
    encoder_launches = phase(8, encoder_path)
    phase(9, encoder_cbr_path)
    refs_launches = phase(10, encoder_refs_path)
    slices_launches = phase(11, encoder_slices_path)
    phase(12, multichip_path)
    print("phase walls s: " + " ".join(f"{n}:{w:.1f}"
                                       for n, w in walls.items())
          + f" total {sum(walls.values()):.1f}")
    for k in kernels:
        k["launches"] = (refs_launches if "refs]" in k["name"]
                         else slices_launches if "bands]" in k["name"]
                         else encoder_launches if k["streams"] == 1
                         else launches)[k["name"].split("[")[0]]
    if "jax" in sys.modules:
        fail("jax was imported during the run")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
