"""One run of one cell: set-up, the measured window, the traced
sub-windows, the check that decides `correct`, and the result line.

Set-up (timed whole as setup_s, from process start): import the port and
load its kernel libraries, make the cell's input rings on the device
from the seed, open the configuration's entry point (entries/<entry>.py:
the BatchEncoder), encode slot 0 (the IDR of all S streams; synchronised
and its NALs pulled: idr_slot_s) and one P slot to warm up. The port is
eager and compiles nothing per shape, so nothing else is warmed.

Window: a closed loop of slots. The next slot's S frames go in as soon
as the entry returns (it returns the slot before's NALs); the loop
stops after the first slot that completes once `seconds` have passed,
and the drain of the last slot falls inside the window. Slot i is an
IDR or a P slot as the configuration's keyint says.

With trace, after the window: one torch.profiler sub-window of a few P
slots (device busy time, operations, kernel times) and a few P slots
with the encoder's StageClock on (it synchronises at each stage).

The check samples P frames over the window's slots, each of another
stream while streams last, so that a fault confined to one stream of the
lockstep batch shows in a share of runs that grows with the sample.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from types import SimpleNamespace

from portbench import catalog, check, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "x264dsp_tpu")
# bytes of a slice NAL kept for its header check (a slice header of these
# streams takes under 16)
HEAD = 32


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sample_streams(rng: random.Random, S: int, k: int) -> list[int]:
    """k streams drawn from rng without replacement while the S streams
    last (then from a fresh permutation), so that k samples see min(k, S)
    different streams."""
    out = []
    while len(out) < k:
        out += rng.sample(range(S), S)
    return out[:k]


def build_param(P, cfg: dict):
    """The port's Param from the configuration file: param_default()
    with each "param" key set (dotted keys reach into its groups; a
    string value names a constant of the params module)."""
    p = P.param_default()
    p.i_width, p.i_height = int(cfg["width"]), int(cfg["height"])
    for key, val in cfg["param"].items():
        obj = p
        *path, last = key.split(".")
        for a in path:
            obj = getattr(obj, a)
        if not hasattr(obj, last):
            raise KeyError(f"the port's Param has no {key}")
        setattr(obj, last, getattr(P, val) if isinstance(val, str) else val)
    return p


def closed_loop(encode, first: int, seconds: float, on_call, on_complete,
                clock=time.perf_counter):
    """The window: encode(j) hands over slot j and returns the NALs of
    slot j - 1 (None while the pipeline fills); encode(None) drains.
    Hands over slots first, first + 1, ... until the first slot that
    completes once `seconds` have passed, then drains the last one.
    on_call(j) runs after each hand-over, on_complete(j, nals, t_hand,
    t_back) for each slot whose NALs came back. Returns (window seconds,
    the last slot, the ms of each hand-over call)."""
    hand, call_ms = {}, []
    i = first
    t_open = clock()
    while True:
        th = clock()
        out = encode(i)
        tb = clock()
        hand[i] = th
        call_ms.append(1e3 * (tb - th))
        on_call(i)
        if out is not None:
            on_complete(i - 1, out, hand.pop(i - 1), tb)
            if tb - t_open >= seconds:
                break
        i += 1
    out = encode(None)
    t_close = clock()
    on_complete(i, out, hand.pop(i), t_close)
    return t_close - t_open, i, call_ms


def _update(d: dict, over: dict | None) -> dict:
    d = dict(d)
    d.update(over or {})
    return d


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", start: float | None = None,
        control: bool = False, overrides: dict | None = None,
        log=print) -> dict | None:
    """One run of cell `name`. Returns the result object, or None when a
    module of JAX or of the JAX package was loaded (named through
    `log`). `overrides` ({"config": ..., "traffic": ..., "workload":
    ...}) replaces keys of the cell's files: the tests run the harness
    at small sizes on the CPU with it."""
    start = time.perf_counter() if start is None else start
    over = overrides or {}
    cell = catalog.cell(name)
    cfg = _update(catalog.config(cell["config"]), over.get("config"))
    traffic = _update(catalog.traffic(cell["traffic"]), over.get("traffic"))
    wl = _update(catalog.workload(name), over.get("workload"))

    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    from x264dsp_tpu_torch import params as P
    entry = catalog.entry(cfg["entry"])
    if cuda:
        from x264dsp_tpu_torch import _build
        _build.lib()
    ref = catalog.reference(cfg["reference"])
    gen = catalog.generator(traffic["generator"])
    W, H = int(cfg["width"]), int(cfg["height"])
    t_ring = time.perf_counter()
    ring_y, ring_u, ring_v = gen.make_ring(traffic, W, H, seed, dev)
    R, S = ring_y.shape[0], ring_y.shape[1]
    sync()
    t_ring, t_import = time.perf_counter() - t_ring, t_ring - start

    def frames(i):
        k = gen.walk(i, R)
        return ring_y[k], ring_u[k], ring_v[k]

    def planes(recon, s):
        return recon[0][s].clone(), torch.stack([recon[1][s], recon[2][s]])

    param = build_param(P, cfg)
    rng = random.Random(seed)
    be = entry.open_entry(param, S, device)
    head = be.headers()
    # each slot's NALs, cut to the slice headers: [per stream: [head]]
    outs = {}

    def keep(j, out):
        outs[j] = [check.slice_nals(nl, HEAD) for nl in (out or [])]

    sync()
    t = time.perf_counter()
    be.encode(frames(0))
    out = be.encode(None)
    sync()
    idr_slot_s = time.perf_counter() - t
    keep(0, out)
    # the streams of the IDR's sample and of each P sample's place
    k_max = int(wl["sample_p_frames"])
    s_idr, *s_of = sample_streams(rng, S, k_max + 1)
    samples = [{"slot": 0, "stream": s_idr, "pre": None,
                "post": planes(be.recon(), s_idr),
                "nals": check.slice_nals(out[s_idr])
                if s_idr < len(out or []) else []}]
    # what a P step that left the state unchanged since the IDR would
    # show, for the check's upper reading of mse_y_max
    idr_y = be.recon()[0].clone()
    t_warm = time.perf_counter()
    be.encode(frames(1))
    keep(1, be.encode(None))
    states = {1: be.recon()}
    sync()
    t_warm = time.perf_counter() - t_warm
    log(f"set-up: import and kernel libraries {t_import:.2f} s, rings "
        f"{t_ring:.2f} s, IDR slot {idr_slot_s:.2f} s, warm-up P slot "
        f"{t_warm:.2f} s")
    bad = forbidden_modules()
    if bad:
        log(f"loaded during set-up: {', '.join(bad)}")
        return None
    setup_s = time.perf_counter() - start

    # -- the window ---------------------------------------------------
    reservoir, seen = [], 0
    slot_ms = []
    frames_done = 0

    def on_call(i):
        states[i] = be.recon()
        states.pop(i - 3, None)

    def on_complete(j, out, t_hand, t_back):
        nonlocal seen, frames_done
        slot_ms.append(1e3 * (t_back - t_hand))
        keep(j, out)
        frames_done += sum(1 for nl in outs[j] if nl)
        seen += 1
        pick = seen - 1 if len(reservoir) < k_max else rng.randrange(seen)
        if pick < k_max:
            s = s_of[pick]
            smp = {"slot": j, "stream": s, "pre": planes(states[j - 1], s),
                   "post": planes(states[j], s),
                   "nals": check.slice_nals(out[s]) if s < len(out or [])
                   else []}
            if pick < len(reservoir):
                reservoir[pick] = smp
            else:
                reservoir.append(smp)

    window_s, i, call_ms = closed_loop(
        lambda j: be.encode(None if j is None else frames(j)), 2,
        seconds, on_call, on_complete)
    window_slots = range(2, i + 1)
    states.clear()

    # -- traced sub-windows ------------------------------------------
    trace_rec, stages = None, None
    nxt = i + 1
    if trace:
        from torch.profiler import ProfilerActivity, profile
        n_prof = int(wl["trace_profile_slots"])
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            for q in range(n_prof):
                out = be.encode(frames(nxt + q))
                if out is not None:
                    keep(nxt + q - 1, out)
            sync()
            tw = time.perf_counter() - t0
        nxt += n_prof
        keep(nxt - 1, be.encode(None))
        trace_rec = tracing.reduce(prof.events(), tw, n_prof)
        del prof
        n_stage = int(wl["trace_stage_slots"])
        be.stage_clock(True)
        for q in range(n_stage):
            out = be.encode(frames(nxt + q))
            if out is not None:
                keep(nxt + q - 1, out)
        nxt += n_stage
        keep(nxt - 1, be.encode(None))
        be.stage_clock(False)
        stages = be.stage_times()
    sync()

    bad = forbidden_modules()
    if bad:
        log(f"loaded once the window closed: {', '.join(bad)}")
        return None
    device_rec = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda
                  else "cpu",
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                      dev)) if cuda else 0}
    if trace_rec is not None:
        device_rec["busy_s"] = trace_rec["busy_s"]
        device_rec["window_s"] = trace_rec["window_s"]
    be.close()
    del be
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------
    t_check = time.perf_counter()
    nals = ref.split_nals(b"".join(n.payload for n in head))
    sps = ref.parse_sps(ref.unescape(nals[0][1:]))
    pps = ref.parse_pps(ref.unescape(nals[1][1:]))
    missing = 0
    slots = []
    for j in sorted(outs):
        streams = outs[j]
        if j in window_slots:
            missing += S - sum(1 for x in streams if x)
        slots.append((j, streams + [[]] * (S - len(streams))))
    n_header = check.header_faults(slots, cfg, sps, pps, ref)
    judged = []
    for smp in samples + reservoir:
        smp["src"] = ring_y[gen.walk(smp["slot"], R), smp["stream"]]
        smp["unchanged"] = idr_y[smp["stream"]]
        judged.append(smp)
    numbers = check.judge_samples(judged, sps, pps, ref, dev, control)
    numbers["frames_missing"] = missing
    numbers["header_faults"] = n_header
    correct, table = check.verdict(numbers, wl["limits"])
    t_check = time.perf_counter() - t_check

    # -- metrics ------------------------------------------------------
    readings = SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, S=S, W=W, H=H,
        me_range=int(param.analyse.i_me_range), setup_s=setup_s,
        idr_slot_s=idr_slot_s, window_s=window_s, frames_done=frames_done,
        slot_ms=slot_ms, call_ms=call_ms, stages=stages, trace=trace_rec,
        device_name=device_rec["kind"])
    metrics = {}
    for m in catalog.metrics_of(name, trace):
        v = catalog.metric(m["name"]).read(readings)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"slots {len(slot_ms)} in a window of {window_s:.3f} s, "
        f"{frames_done} frames; the check took {t_check:.1f} s of "
        f"{time.perf_counter() - start:.1f} s")
    if trace_rec is not None:
        from portbench import roofline
        for fam in ("sad", "windows"):
            sh = roofline.share(readings, fam)
            if sh is not None:
                log(f"{fam} roofline bound by {sh[1]}")
    log(f"mse_y_unchanged {numbers['mse_y_unchanged']} (mse_y_max of the "
        "same samples had no P step changed the state since the IDR)")
    for k, (v, lim) in table.items():
        log(f"check {k} {v} limit {lim}")
    result = {"correct": bool(correct),
              "attempted": S * len(window_slots),
              "failed": missing + n_header,
              "metrics": metrics, "device": device_rec}
    if trace_rec is not None:
        result["breakdown"] = trace_rec["breakdown"]
    result["checks"] = table
    return result
