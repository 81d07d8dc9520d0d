"""The check that decides `correct` on whole harness runs at a small
size on the CPU: a sound run is correct; the control (the reference's
own pictures at 7-bit precision in the encoder's place) and each fault
the cells can have, planted under the timed path, are not. The cells
run on one card, so no exchange between chips can be left out."""

import pytest
import torch

from x264dsp_tpu_torch.encoder import batch, core

CELLS = ["superfast-pan-s32", "faster-split-s16"]


def checks(r):
    return {k: v for k, (v, _) in r["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(run_small, cell):
    r, lines = run_small(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert lines[-1].startswith("check mse_y_max ")
    assert set(r["metrics"]) == {"fps", "slot_ms_p90", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_small, cell):
    r, _ = run_small(cell, control=True)
    assert not r["correct"]
    assert checks(r)["mismatch_px"] > 0


def test_state_left_unchanged_is_not_correct(run_small, monkeypatch):
    """The P step returns the encoder's reference state unchanged."""
    orig = core.frame_step
    last = {}

    def step(cfg, is_p, fy, fu, fv, refs, *a):
        out = orig(cfg, is_p, fy, fu, fv, refs, *a)
        if is_p and "recon" in last:
            out["planes"], out["recon"] = refs, last["recon"]
        last["recon"] = out["recon"]
        return out
    monkeypatch.setattr(core, "frame_step", step)
    r, _ = run_small("superfast-pan-s32")
    assert not r["correct"]
    assert checks(r)["mismatch_px"] > 0


def test_half_the_batch_left_out_is_not_correct(run_small, monkeypatch):
    """encode_batch gives back the NALs of half of the streams."""
    orig = batch.BatchEncoder.encode_batch

    def half(self, pics):
        out = orig(self, pics)
        return None if out is None else out[:len(out) // 2]
    monkeypatch.setattr(batch.BatchEncoder, "encode_batch", half)
    r, _ = run_small("faster-split-s16")
    assert not r["correct"]
    assert checks(r)["frames_missing"] > 0


def test_altered_token_is_not_correct(run_small, monkeypatch):
    """One bit of every slice is flipped where the NALs are framed."""
    orig = batch.BatchEncoder.encode_batch

    def flip(self, pics):
        out = orig(self, pics)
        for nals in out or []:
            n = nals[-1]
            p = bytearray(n.payload)
            p[len(p) * 2 // 3] ^= 0x10
            n.payload = bytes(p)
        return out
    monkeypatch.setattr(batch.BatchEncoder, "encode_batch", flip)
    r, _ = run_small("superfast-pan-s32")
    assert not r["correct"]
    c = checks(r)
    assert c["mismatch_px"] + c["decode_errors"] > 0


def test_one_stream_altered_is_not_correct(run_small, monkeypatch):
    """One bit of the last stream's slice is flipped in every slot (a
    fault at one index of the lockstep batch); the samples are drawn
    without replacement over the streams, so they reach it."""
    orig = batch.BatchEncoder.encode_batch

    def flip(self, pics):
        out = orig(self, pics)
        if out:
            n = out[-1][-1]
            p = bytearray(n.payload)
            p[len(p) * 2 // 3] ^= 0x10
            n.payload = bytes(p)
        return out
    monkeypatch.setattr(batch.BatchEncoder, "encode_batch", flip)
    r, _ = run_small("faster-split-s16")
    assert not r["correct"]
    c = checks(r)
    assert c["mismatch_px"] + c["decode_errors"] > 0


@pytest.mark.gpu
def test_cell_on_the_card_is_correct(run_small):
    """The harness on the card at the small size (the CUDA kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import harness
    from .conftest import small
    r = harness.run("faster-split-s16", 5, 0.6, True, device="cuda",
                    overrides=small("faster-split-s16"), log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
