"""The plain reference decoder against the port on the CPU: every
picture of both configurations decodes, from the encoder's reference
planes of the picture before, to exactly the encoder's planes; a
corrupted slice does not."""

import pytest
import torch

from portbench import catalog, check, harness
from portbench.reference import h264 as D

from .conftest import small


def encode_clip(cell, n=4):
    from x264dsp_tpu_torch import params as P
    from x264dsp_tpu_torch.encoder import batch
    over = small(cell)
    c = catalog.cell(cell)
    cfg = dict(catalog.config(c["config"]), **over["config"])
    cfg["keyint"] = 3
    tr = dict(catalog.traffic(c["traffic"]), **over["traffic"])
    param = harness.build_param(P, cfg)
    param.i_keyint_max = 3
    y, u, v = catalog.generator(tr["generator"]).make_ring(
        tr, cfg["width"], cfg["height"], 99, "cpu")
    be = batch.BatchEncoder(param, 2, device="cpu")
    nals = D.split_nals(b"".join(x.payload for x in be.headers()))
    sps = D.parse_sps(D.unescape(nals[0][1:]))
    pps = D.parse_pps(D.unescape(nals[1][1:]))
    recon, outs = [], []
    for i in range(n):
        out = be.encode_batch((y[i % 4], u[i % 4], v[i % 4]))
        recon.append([t.clone() for t in be.last_recon])
        if out is not None:
            outs.append(out)
    outs.append(be.encode_batch(None))
    return cfg, sps, pps, recon, outs


@pytest.fixture(scope="module", params=["superfast-pan-s32",
                                        "faster-split-s16"])
def clip(request):
    torch.set_num_threads(2)
    return encode_clip(request.param)


def planes(rec, s):
    return rec[0][s], torch.stack([rec[1][s], rec[2][s]])


def test_decodes_to_the_encoders_planes(clip):
    cfg, sps, pps, recon, outs = clip
    types = []
    for i, out in enumerate(outs):
        for s in range(2):
            (nal,) = check.slice_nals(out[s])
            ref = None if i % cfg["keyint"] == 0 else planes(recon[i - 1], s)
            (h, (y, c)), = D.decode_pictures([(nal, ref)], sps, pps, "cpu")
            types.append(h["slice_type"])
            assert torch.equal(y, recon[i][0][s])
            assert torch.equal(c[0], recon[i][1][s])
            assert torch.equal(c[1], recon[i][2][s])
    assert set(types) == {0, 2}


def test_a_flipped_bit_does_not_decode_to_the_same_planes(clip):
    cfg, sps, pps, recon, outs = clip
    (nal,) = check.slice_nals(outs[1][0])
    bad = bytearray(nal)
    bad[len(bad) // 2] ^= 0x08
    try:
        (h, (y, c)), = D.decode_pictures([(bytes(bad), planes(recon[0], 0))],
                                         sps, pps, "cpu")
    except D.BitstreamError:
        return
    assert not (torch.equal(y, recon[1][0][0])
                and torch.equal(c[0], recon[1][1][0]))


def test_header_check_follows_the_gop(clip):
    cfg, sps, pps, recon, outs = clip
    slots = [(j, [check.slice_nals(nl, 32) for nl in out])
             for j, out in enumerate(outs)]
    assert check.header_faults(slots, cfg, sps, pps, D) == 0
    # a slot out of place in the GOP: every stream's header is wrong
    assert check.header_faults([(j + 1, st) for j, st in slots], cfg, sps,
                               pps, D) == 2 * len(slots)
