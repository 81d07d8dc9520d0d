"""Smoke run of the PyTorch / CUDA port on one GPU: python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. setup: the card's name and power limit, the CUDA kernel build;
  2. each hand-written kernel (K1 SAD surface, K2a/K2b MC windows, K3
     deblock) against its plain PyTorch version at the 1920x1088 main-path
     shapes (R = 16, S = 8), exact equality, with CUDA-event times;
  3. the BatchEncoder on the GPU against the same on the CPU, on a small
     64x48 clip (S = 2, keyint 4, 6 frames): identical Annex-B bytes;
  4. the main path: BatchEncoder at 1920x1088, S = 8, QP 26, keyint 50,
     CAVLC, one I slot and four P slots of a synthetic clip; every kernel's
     launch counter must be above 0; prints fps and the per-stage split.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
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


def kernel_checks():
    """Phase 2: every kernel against its plain version, main-path shapes."""
    import torch
    from x264dsp_tpu.ops.tables import CHROMA_QP_TABLE
    from x264dsp_tpu_torch.ops import deblock as DB
    from x264dsp_tpu_torch.ops import mc as MC
    from x264dsp_tpu_torch.ops import mcgather as MG
    from x264dsp_tpu_torch.ops import me_sad
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    mb_w, mb_h = W // 16, H // 16
    S = S_MAIN
    rec = []

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    fenc = t(rng.integers(0, 256, (S, H, W)))
    recon = t(rng.integers(0, 256, (S, H, W)), torch.uint8)
    ref4 = MC.make_ref_planes(recon).contiguous()
    strips = me_sad.make_ref_strips(ref4[:, 0], MC.PAD_MC, mb_w, mb_h, R)
    refc = MC.pad_chroma(t(rng.integers(0, 256, (S, H // 2, W // 2)),
                           torch.uint8)).contiguous()

    cases = [
        ("sad_surface16", "x264dsp_tpu_torch/csrc/me_sad.cu",
         "x264dsp_tpu/ops/pallas/me_sad.py:138",
         lambda: me_sad.sad_cost_surface16_lanes_cuda(fenc, strips, mb_w,
                                                      mb_h, R),
         lambda: me_sad.sad_cost_surface16_lanes_plain(fenc, strips, mb_w,
                                                       mb_h, R), 10, 1),
        ("luma_windows", "x264dsp_tpu_torch/csrc/windows.cu",
         "x264dsp_tpu/ops/pallas/windows.py:30",
         lambda: MG.luma_windows_cuda(ref4, mb_w, mb_h),
         lambda: MG.luma_windows_plain(ref4, mb_w, mb_h), 10, 3),
        ("chroma_windows", "x264dsp_tpu_torch/csrc/windows.cu",
         "x264dsp_tpu/ops/pallas/windows.py:68",
         lambda: MG.chroma_windows_cuda(refc, mb_w, mb_h),
         lambda: MG.chroma_windows_plain(refc, mb_w, mb_h), 10, 3),
    ]
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
              t(np.zeros(grid)), t(rng.random(grid) < 0.2), t(qp), t(qpc),
              0, 0, mb_w, mb_h)
    i_args = (y, u, v, t(np.full(grid + (2, 4, 4), 3)), t(np.ones(grid)),
              t(np.zeros(grid)), t(qp), t(qpc), 0, 0, mb_w, mb_h)
    for tag, args in (("P", p_args), ("I", i_args)):
        cases.append((f"deblock[{tag}]", "x264dsp_tpu_torch/csrc/deblock.cu",
                      "x264dsp_tpu/ops/pallas/deblock_skew.py:258",
                      lambda a=args: DB.deblock_frame_cuda(*a),
                      lambda a=args: DB.deblock_frame_plain(*a), 10, 1))

    for name, src, replaces, kern, plain, reps, preps in cases:
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = max_err(got, want)
        del got, want
        ms = time_cuda(kern, reps)
        plain_ms = time_cuda(plain, preps)
        print(f"kernel {name:16s} max_abs_err {err}  {ms:9.3f} ms  "
              f"plain {plain_ms:10.3f} ms")
        if err != 0:
            fail(f"kernel {name} disagrees with its plain version")
        rec.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms))
    return rec


def small_clip(w, h, n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n):
        y = (110 + 60 * np.sin((xx + 2 * t) / 13.0) * np.cos(yy / 17.0)
             + rng.normal(0, 2.0, (h, w))).clip(0, 255).astype(np.uint8)
        u = (120 + 30 * np.sin((xx[::2, ::2] + t) / 23.0)).clip(
            0, 255).astype(np.uint8)
        v = (128 + 30 * np.cos((yy[::2, ::2] + t) / 29.0)).clip(
            0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def encode(be, batches):
    """Run stacked (y, u, v) batches through a BatchEncoder; returns the
    per-stream byte streams and the per-slot deblocked recon planes, as
    the encoder's own device tensors (kept, not copied: no host transfer
    or sync inside a timed run)."""
    import torch
    streams = [b""] * be.S
    recons = []
    for item in list(batches) + [None]:
        out = be.encode_batch(item)
        if item is not None:
            recons.append(be.last_recon)
        if out is not None:
            for s, nl in enumerate(out):
                streams[s] += b"".join(n.payload for n in nl)
    be.close()
    if be.device.type == "cuda":
        torch.cuda.synchronize()
    return streams, recons


def card_vs_cpu():
    """Phase 3: identical bytes from the GPU and the CPU BatchEncoder."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch.tools.mainpath import main_path_param
    w, h, S, n = 64, 48, 2, 6
    clips = [small_clip(w, h, n, 11 + s) for s in range(S)]
    batches = [tuple(torch.from_numpy(np.stack([clips[s][t][i]
                                                for s in range(S)]))
                     for i in range(3)) for t in range(n)]
    out = {}
    for dev in ("cuda", "cpu"):
        be = xtt.BatchEncoder(main_path_param(w, h, 26, 4), S, device=dev)
        out[dev], _ = encode(be, batches)
    same = out["cuda"] == out["cpu"]
    print(f"card vs CPU, 64x48 S=2 keyint 4, 6 frames: bytes "
          f"{[len(b) for b in out['cuda']]} identical={same}")
    if not same or not all(out["cpu"]):
        fail("the card's Annex-B bytes differ from the CPU's")


def psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main_path(n_p: int = 4):
    """Phase 4: the 1080p 8-stream main path through the BatchEncoder."""
    import torch
    import x264dsp_tpu_torch as xtt
    from x264dsp_tpu_torch.tools.mainpath import (main_path_param,
                                                  stacked_slot, synth_clip)
    frame = synth_clip(W, H, torch.device("cuda"))
    S = S_MAIN
    batches = [stacked_slot(frame, t, S) for t in range(1 + n_p)]
    param = main_path_param(W, H, QP, KEYINT)
    torch.cuda.synchronize()

    xtt.reset_kernel_launches()
    be = xtt.BatchEncoder(param, S, device="cuda")
    t0 = time.perf_counter()
    streams, recons = encode(be, batches)
    wall = time.perf_counter() - t0
    launches = xtt.kernel_launches()
    print(f"main path 1920x1088 S={S} QP {QP}: 1 I + {n_p} P slots in "
          f"{wall:.3f} s = {S * (1 + n_p) / wall:.3f} fps "
          f"(bytes/stream {[len(b) for b in streams]})")
    print(f"kernel launches in the main path: {launches}")
    if min(launches.values()) <= 0:
        fail("a kernel of the main path was never launched")
    # output check: every stream coded, recon close to the source
    worst = 99.0
    for t, (ry, _, _) in enumerate(recons):
        ry, src = ry.cpu().numpy(), batches[t][0].cpu().numpy()
        for s in range(S):
            worst = min(worst, psnr(ry[s], src[s]))
    print(f"main path recon: worst luma PSNR {worst:.2f} dB over "
          f"{len(recons)} slots x {S} streams")
    if worst < 30.0 or min(len(b) for b in streams) == 0:
        fail("main path output is wrong (empty stream or PSNR < 30 dB)")

    # the same slots once more with stage timing (synchronizes the device
    # at each stage and serializes the entropy pipeline)
    be = xtt.BatchEncoder(param, S, device="cuda", profile=True)
    encode(be, batches)
    for kind, name in ((2, "I"), (0, "P")):
        rows = [tm for st, tm in be.slot_times if st == kind]
        if not rows:
            continue
        avg = {k: 1000 * sum(r.get(k, 0.0) for r in rows) / len(rows)
               for k in ("encode", "deblock", "ref_planes", "pull", "cavlc")}
        total = sum(avg.values())
        print(f"{name} slot ms (mean of {len(rows)}): "
              + " ".join(f"{k} {v:.2f}" for k, v in avg.items())
              + f" | total {total:.2f}")
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
    setup()
    kernels = kernel_checks()
    card_vs_cpu()
    launches = main_path()
    for k in kernels:
        k["launches"] = launches[k["name"].split("[")[0]]
    if "jax" in sys.modules:
        fail("jax was imported during the run")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
