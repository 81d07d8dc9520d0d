"""The comparison that decides a run's `correct`.

The encoder's outputs are judged by the plain reference decoder
(reference/h264.py), which shares nothing with the encoder:

- every frame handed over in the window comes back for every stream
  (``frames_missing``), as the configuration's number of slices, whose
  headers say what the configuration and the slot's place in the GOP
  say: NAL and slice type, first macroblocks in order from 0, frame_num,
  idr_pic_id, a QP inside the configuration's range for the slice type,
  the deblocking flag (``header_faults``);
- a sample of frames drawn from the seed, and the set-up's IDR of one
  stream, decode by the standard (``decode_errors``) to exactly the
  planes the encoder keeps as its reference for the next slot
  (``mismatch_px``: the pixels that differ). A P frame is decoded from
  the encoder's reference planes of the slot before it (the program's
  state: a decode of the whole stream from its IDR would take longer
  than the window), the IDR from nothing;
- the decoded luma is near its source (``mse_y_max``: the worst mean
  squared error of a sampled frame), which an encoder whose frames decode
  to what it predicts but leave the picture behind would not be.

The control (``control=True``) puts the reference itself in the
encoder's place at the next lower sample precision, 7 bits of the
configuration's 8: every sampled picture is the reference's decode with
its lowest bit cleared.
"""

from __future__ import annotations

NAMES = ("frames_missing", "header_faults", "decode_errors", "mismatch_px",
         "mse_y_max")


def slice_nals(nal_list, head: int | None = None) -> list[bytes]:
    """A stream's NAL objects of one slot (each one Annex-B NAL unit) ->
    its slice NAL units without their start codes, or their first
    `head` bytes (enough for the slice header)."""
    out = []
    for n in nal_list:
        p = n.payload
        k = p.find(b"\x00\x00\x01", 0, 4)
        if k < 0 or len(p) < k + 4:
            out.append(b"")
            continue
        if p[k + 3] & 0x1F in (1, 5):
            out.append(p[k + 3:] if head is None else p[k + 3:k + 3 + head])
    return out


def qp_range(cfg: dict, slice_type: str) -> tuple[int, int]:
    """The configuration's slice QPs of one slice type ("I" or "P"): a
    number (that QP exactly) or [lowest, highest]."""
    q = cfg["slice_qp"][slice_type]
    lo, hi = (q, q) if isinstance(q, (int, float)) else q
    return int(lo), int(hi)


def header_faults(slots, cfg: dict, sps: dict, pps: dict, ref) -> int:
    """slots: [(slot index, [per stream: [slice NAL (or its first bytes),
    ...]])] in order. Counts the frames whose slices are missing, more or
    fewer than the configuration's "slices", or say another thing than
    the slot's place in the GOP and the configuration."""
    keyint = int(cfg["keyint"])
    n_slices = int(cfg["slices"])
    wrap = 1 << sps["log2_max_frame_num"]
    deblock_idc = 0 if cfg["deblock"] else 1
    qps = {True: qp_range(cfg, "I"), False: qp_range(cfg, "P")}
    faults = 0
    last_idr_id = {}
    for j, streams in slots:
        idr = j % keyint == 0
        lo, hi = qps[idr]
        for s, nals in enumerate(streams):
            if len(nals) != n_slices:
                faults += 1
                continue
            try:
                hs = [ref.parse_slice_header(n, sps, pps)[0] for n in nals]
            except ref.BitstreamError:
                faults += 1
                continue
            firsts = [h["first_mb"] for h in hs]
            ok = firsts[0] == 0 and firsts == sorted(set(firsts))
            for h in hs:
                ok = ok and (h["nal_type"] == (5 if idr else 1)
                             and h["nal_ref_idc"]
                             and h["slice_type"] == (2 if idr else 0)
                             and h["frame_num"] == (j % keyint) % wrap
                             and lo <= h["qp"] <= hi
                             and h["deblock"] == deblock_idc)
            if ok and idr:
                ids = {h["idr_pic_id"] for h in hs}
                ok = len(ids) == 1 and ids != {last_idr_id.get(s)}
                last_idr_id[s] = hs[0]["idr_pic_id"]
            faults += not ok
    return faults


def judge_samples(samples, sps: dict, pps: dict, ref, device,
                  control: bool = False) -> dict:
    """samples: dicts with nals (the picture's slice NALs), pre (the encoder's planes
    of the slot before, (y, c) uint8, or None for an IDR), post (its
    planes after the slot), src (the source luma) and unchanged (the
    stream's luma after its IDR). Returns the numbers decode_errors,
    mismatch_px, mse_y_max and, for that limit's upper reading,
    mse_y_unchanged: mse_y_max had no P step changed the state since the
    IDR (the fault of a step that returns its state unchanged)."""
    parsed, errors = [], 0
    for smp in samples:
        try:
            h, f = ref.parse_frame(smp["nals"], sps, pps)
            rec = ref.reconstruct(f, smp["pre"], device,
                                  pps["chroma_qp_offset"])
        except (ref.BitstreamError, IndexError):
            # IndexError: a corrupt stream can point outside the picture
            errors += 1
            continue
        parsed.append((smp, (h, f, rec)))
    decoded = ref.deblock_pictures([p for _, p in parsed], sps, pps, device)
    mismatch, mse_max, unchanged = 0, 0.0, 0.0
    for (smp, _), (y, c) in zip(parsed, decoded):
        py, pc = (y & 0xFE, c & 0xFE) if control else (
            smp["post"][0].to(device), smp["post"][1].to(device))
        mismatch += int((py != y).sum()) + int((pc != c).sum())
        src = smp["src"].to(device).float()
        mse_max = max(mse_max, float(((py.float() - src) ** 2).mean()))
        unchanged = max(unchanged, float(
            ((smp["unchanged"].to(device).float() - src) ** 2).mean()))
    return {"decode_errors": errors, "mismatch_px": mismatch,
            "mse_y_max": mse_max, "mse_y_unchanged": unchanged}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every compared number at or below its limit. Returns (correct,
    {name: [number, limit]}) in NAMES' order."""
    table = {k: [numbers[k], limits[k]] for k in NAMES}
    return all(v <= lim for v, lim in table.values()), table

