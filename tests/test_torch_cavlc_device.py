"""The port's device CAVLC (x264dsp_tpu_torch/entropy/cavlc_device.py).

On the CPU, random syntax (the generators of tests/test_cavlc_device.py,
two streams stacked) goes through the port's packer and through the
port's host C++ writers: payload bytes, bit counts, skip counts and
end-of-row bit positions must be identical. One P shape also goes
through the JAX packer itself (one compile), including a case whose
macroblocks pass the packer's 128-word limit, where both must raise the
overflow flag. The I-slice packer meets the JAX one in
tests/test_torch_batch.py, on the slots of the encoded clip (the JAX
BatchEncoder compiles it there anyway).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_jaxref import light_xla
from test_cavlc_device import (MB_H, MB_W, _headers, _headers_i, _rand_syn,
                               _rand_syn_i)
from x264dsp_tpu.entropy import cavlc_device as JCD
from x264dsp_tpu_torch.entropy import cavlc_device as TCD
from x264dsp_tpu_torch.entropy import native
from x264dsp_tpu_torch.entropy.bitstream import BitWriter

S = 2
B = MB_W * MB_H
CAP = 1 << 16
P_KEYS = ("partition", "ref", "cbp_luma", "cbp_chroma", "mv8", "luma_levels",
          "chroma_dc_levels", "chroma_ac_levels")


def _stack(syns, keys=None):
    keys = keys or syns[0].keys()
    return {k: torch.from_numpy(np.stack([s[k].astype(np.int32)
                                          for s in syns])) for k in keys}


def _qp_grids(rng):
    return rng.integers(22, 30, (S, MB_H, MB_W)).astype(np.int16)


def _port_p(syns, qp_mb, n_ref, header, cap=CAP):
    hv, hl = TCD.header_elements(*header)
    payload, bits, n_skip, ov, rows = TCD.cavlc_p_payload(
        _stack(syns, P_KEYS), torch.from_numpy(qp_mb.astype(np.int32)), 26,
        n_ref, MB_H, MB_W, hv, hl, cap, with_rows=True)
    return payload.numpy(), bits.numpy(), n_skip.numpy(), ov.numpy(), \
        rows.numpy()


def _port_i(syns, qp_mb, header, cap=CAP):
    hv, hl = TCD.header_elements(*header)
    payload, bits, ov, rows = TCD.cavlc_i_payload(
        _stack(syns), torch.from_numpy(qp_mb.astype(np.int32)), 26, MB_H,
        MB_W, hv, hl, cap, with_rows=True)
    return payload.numpy(), bits.numpy(), ov.numpy(), rows.numpy()


def _native_p(syn, qp_mb, n_ref, header):
    rows = np.zeros(MB_H, np.int64)
    payload, n_skip = native.write_slice_p(header, MB_W, MB_H, 26, syn,
                                           qp_mb=qp_mb, n_ref=n_ref,
                                           row_bits=rows)
    return payload, n_skip, rows


def _check_p(syns, qp_mb, n_ref, header):
    payload, bits, n_skip, ov, rows = _port_p(syns, qp_mb, n_ref, header)
    assert not ov.any()
    for s in range(S):
        want, want_skip, want_rows = _native_p(syns[s], qp_mb[s], n_ref,
                                               header)
        nbytes = (int(bits[s]) + 7) // 8
        assert nbytes == len(want)
        assert payload[s, :nbytes].tobytes() == want, f"stream {s}"
        assert not payload[s, nbytes:].any()
        assert int(n_skip[s]) == want_skip
        np.testing.assert_array_equal(rows[s], want_rows)


@pytest.mark.parametrize("seed,density,parts,n_ref,scale", [
    (0, 0.3, False, 1, 3),
    (1, 0.5, True, 1, 3),
    (2, 0.15, True, 2, 2),
    (3, 0.7, True, 1, 40),      # large levels: suffix chain + escapes
    (4, 0.02, False, 1, 1),     # nearly empty: skip runs / empty blocks
])
def test_p_payload_matches_native(seed, density, parts, n_ref, scale):
    rng = np.random.default_rng(seed)
    syns = [_rand_syn(rng, density=density, partitions=parts, n_ref=n_ref,
                      level_scale=scale) for _ in range(S)]
    _check_p(syns, _qp_grids(rng), n_ref, _headers())


def test_p_all_skip_frame():
    syns = []
    for s in range(S):
        syn = _rand_syn(np.random.default_rng(9 + s), density=0.0,
                        skip_frac=1.0, partitions=False)
        for k in ("cbp_luma", "cbp_chroma", "partition", "ref", "mv8"):
            syn[k][:] = 0
        syns.append(syn)
    qp_mb = np.full((S, MB_H, MB_W), 26, np.int16)
    _check_p(syns, qp_mb, 1, _headers())
    assert (_port_p(syns, qp_mb, 1, _headers())[2] == B).all()


@pytest.mark.parametrize("extra_bits", [1, 3, 6])
def test_p_header_alignments(extra_bits):
    """Slice headers that end at different bit offsets (and the
    byte-aligned one, whose trailing byte carries 0 bits)."""
    hw = BitWriter()
    hw.write(8, 0xA5)
    header_aligned = hw.get_unaligned()
    assert header_aligned[1] == 0
    hw.write(extra_bits, 1)
    rng = np.random.default_rng(30 + extra_bits)
    syns = [_rand_syn(rng, density=0.3) for _ in range(S)]
    qp_mb = _qp_grids(rng)
    _check_p(syns, qp_mb, 1, hw.get_unaligned())
    _check_p(syns, qp_mb, 1, header_aligned)


@pytest.mark.parametrize("seed,density,scale", [
    (0, 0.3, 3), (1, 0.6, 25), (2, 0.05, 1)])
def test_i_payload_matches_native(seed, density, scale):
    rng = np.random.default_rng(seed)
    syns = [_rand_syn_i(rng, density=density, level_scale=scale)
            for _ in range(S)]
    qp_mb = _qp_grids(rng)
    header = _headers_i()
    payload, bits, ov, rows = _port_i(syns, qp_mb, header)
    assert not ov.any()
    for s in range(S):
        want_rows = np.zeros(MB_H, np.int64)
        want = native.write_slice_i(header, MB_W, MB_H, 26, syns[s],
                                    qp_mb=qp_mb[s], row_bits=want_rows)
        nbytes = (int(bits[s]) + 7) // 8
        assert payload[s, :nbytes].tobytes() == want, f"stream {s}"
        assert not payload[s, nbytes:].any()
        np.testing.assert_array_equal(rows[s], want_rows)


def test_batched_payload_is_the_streams_back_to_back():
    rng = np.random.default_rng(20)
    syns = [_rand_syn(rng, density=0.35) for _ in range(S)]
    qp_mb = _qp_grids(rng)
    hv, hl = TCD.header_elements(*_headers())
    payload, off, n_skip, ov = TCD.cavlc_p_payload_batched(
        _stack(syns, P_KEYS), torch.from_numpy(qp_mb.astype(np.int32)), 26,
        1, MB_H, MB_W, hv, hl, CAP)
    assert not ov.any() and payload.shape == (CAP,)
    for s in range(S):
        want, want_skip, _ = _native_p(syns[s], qp_mb[s], 1, _headers())
        assert payload[off[s]:off[s + 1]].numpy().tobytes() == want
        assert int(n_skip[s]) == want_skip
    isyns = [_rand_syn_i(rng) for _ in range(S)]
    hv, hl = TCD.header_elements(*_headers_i())
    payload, off, ov = TCD.cavlc_i_payload_batched(
        _stack(isyns), torch.from_numpy(qp_mb.astype(np.int32)), 26, MB_H,
        MB_W, hv, hl, CAP)
    assert not ov.any()
    for s in range(S):
        want = native.write_slice_i(_headers_i(), MB_W, MB_H, 26, isyns[s],
                                    qp_mb=qp_mb[s])
        assert payload[off[s]:off[s + 1]].numpy().tobytes() == want


def _overflow_syns(kind):
    """Stream 0 overflows, stream 1 does not. 'escape': one level whose
    escape code passes 12 bits (cavlc.c:56-60); 'mb': dense large levels,
    an MB longer than the packer's 128 words."""
    rng = np.random.default_rng(40)
    syns = [_rand_syn(rng, density=0.3, skip_frac=0.0) for _ in range(S)]
    bad = syns[0]
    bad["cbp_luma"][1, 2] = 15
    if kind == "escape":
        bad["luma_levels"][1, 2, 5, 3] = 5000
    else:
        bad["luma_levels"][1, 2] = rng.integers(
            500, 2000, (16, 16)) * rng.choice([-1, 1], (16, 16))
    return syns, _qp_grids(rng)


@pytest.mark.parametrize("kind", ["escape", "mb"])
def test_overflow_flag_is_raised_per_stream(kind):
    syns, qp_mb = _overflow_syns(kind)
    _, bits, _, ov, _ = _port_p(syns, qp_mb, 1, _headers())
    assert ov.tolist() == [True, False]
    # the stream cap: both streams pass a 256-byte buffer
    _, bits_small, _, ov_small, _ = _port_p(syns, qp_mb, 1, _headers(), 256)
    assert ov_small.all() and (bits_small > 256 * 8).all()
    np.testing.assert_array_equal(bits_small, bits)


# ---------------------------------------------------------------------------
# against the JAX packer itself
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_p():
    return jax.jit(lambda s, q, hv, hl: JCD.cavlc_p_payload(
        s, q, 26, 1, MB_H, MB_W, hv, hl, cap_bytes=CAP, with_rows=True))


@pytest.mark.parametrize("case", ["dense-partitions", "mb-overflow"])
def test_p_payload_matches_jax(jax_p, case):
    if case == "mb-overflow":
        syns, qp_mb = _overflow_syns("mb")
    else:
        rng = np.random.default_rng(50)
        syns = [_rand_syn(rng, density=0.5, level_scale=12)
                for _ in range(S)]
        qp_mb = _qp_grids(rng)
    header = _headers()
    payload, bits, n_skip, ov, rows = _port_p(syns, qp_mb, 1, header)
    hv, hl = JCD.header_elements(*header)
    for s in range(S):
        syn_j = {k: jnp.asarray(syns[s][k]) for k in P_KEYS}
        with light_xla():
            want = jax_p(syn_j, jnp.asarray(qp_mb[s]), hv, hl)
        w_payload, w_bits, w_skip, w_ov, w_rows = map(np.asarray, want)
        assert bool(ov[s]) == bool(w_ov)
        assert bool(w_ov) == (case == "mb-overflow" and s == 0)
        assert int(bits[s]) == int(w_bits)
        assert int(n_skip[s]) == int(w_skip)
        np.testing.assert_array_equal(rows[s], w_rows)
        if not w_ov:
            np.testing.assert_array_equal(payload[s], w_payload)


def test_mvp_field_matches_jax():
    rng = np.random.default_rng(70)
    syns = [_rand_syn(rng, density=0.3, n_ref=2) for _ in range(S)]
    st = _stack(syns, ("mv8", "partition", "ref"))
    mvp, pskip = TCD.mvp_field(st["mv8"], st["partition"], st["ref"], MB_H,
                               MB_W)
    part_n = np.array([1, 2, 2, 4])
    j_mvp = jax.jit(lambda m, p, r: JCD.mvp_field(m, p, r, MB_H, MB_W))
    for s in range(S):
        w_mvp, w_pskip = j_mvp(
            jnp.asarray(syns[s]["mv8"].astype(np.int32)),
            jnp.asarray(syns[s]["partition"].astype(np.int32)),
            jnp.asarray(syns[s]["ref"].astype(np.int32)))
        used = np.arange(4) < part_n[syns[s]["partition"]][..., None]
        np.testing.assert_array_equal(
            np.where(used[..., None], mvp[s].numpy(), 0),
            np.where(used[..., None], np.asarray(w_mvp), 0))
        np.testing.assert_array_equal(pskip[s].numpy(), np.asarray(w_pskip))
