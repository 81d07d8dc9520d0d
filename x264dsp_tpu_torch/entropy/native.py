"""ctypes loader for the host C++ slice writers, CAVLC and CABAC
(``csrc/host/entropy.cpp``).

Copied from x264dsp_tpu/entropy/native.py (the C++ source byte for byte
from x264dsp_tpu/entropy/native/entropy.cpp), with two differences:
- g++ builds the library at first use into the checkout's ``build/native/``
  (listed in ``.gitignore``), named by a hash of the source and renamed
  into place atomically, so two checkouts or two processes never share or
  race on one file;
- a failed build raises: there is no Python-writer fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "host" / "entropy.cpp"
LIB_DIR = _PKG.parent / "build" / "native"

_lib = None
_lock = threading.Lock()   # get_lib races under thread-pool entropy


def _build() -> Path:
    src = _SRC.read_bytes()
    lib_path = LIB_DIR / (
        f"libx264t_entropy_{hashlib.sha256(src).hexdigest()[:16]}.so")
    if lib_path.exists():
        return lib_path
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
            "-o", str(tmp)]
    errors = []
    # -march=native is worth ~2.2x on the bit-serial loops; fall back
    # for toolchains that reject it
    for flags in (base[:2] + ["-march=native"] + base[2:], base):
        try:
            res = subprocess.run(flags, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"the C++ slice writers need g++: {e}") from e
        if res.returncode == 0:
            os.replace(tmp, lib_path)
            return lib_path
        errors.append(res.stderr)
    raise RuntimeError("g++ failed to build the C++ slice writers:\n"
                       + "\n".join(errors))


def get_lib():
    """The loaded library (built on first call; thread-safe). Raises if
    it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.x264tpu_write_slice_i.restype = ctypes.c_int64
        lib.x264tpu_write_slice_p.restype = ctypes.c_int64
        lib.x264tpu_write_slice_cabac.restype = ctypes.c_int64

        from .cavlc_tables import (COEFF0_TOKEN, COEFF_TOKEN, TOTAL_ZEROS,
                                   TOTAL_ZEROS_2x2_DC)
        coeff0 = np.array(COEFF0_TOKEN, np.uint16)
        ct = np.array(COEFF_TOKEN, np.uint16)
        tz = np.array(TOTAL_ZEROS, np.uint16)
        tzdc = np.array(TOTAL_ZEROS_2x2_DC, np.uint16)
        lib.x264tpu_set_cavlc_tables(
            coeff0.ctypes.data_as(ctypes.c_void_p),
            ct.ctypes.data_as(ctypes.c_void_p),
            tz.ctypes.data_as(ctypes.c_void_p),
            tzdc.ctypes.data_as(ctypes.c_void_p))

        from .cabac_tables import (CONTEXTS, RANGE_LPS, RENORM_SHIFT,
                                   TRANSITION)
        cx = np.ascontiguousarray(CONTEXTS, np.uint8)
        rl = np.ascontiguousarray(RANGE_LPS, np.uint8)
        rs = np.ascontiguousarray(RENORM_SHIFT, np.uint8)
        tr = np.ascontiguousarray(TRANSITION, np.uint8)
        lib.x264tpu_set_cabac_tables(
            cx.ctypes.data_as(ctypes.c_void_p),
            rl.ctypes.data_as(ctypes.c_void_p),
            rs.ctypes.data_as(ctypes.c_void_p),
            tr.ctypes.data_as(ctypes.c_void_p))
        _lib = lib
    return _lib


def _i32(a):
    # the C side reads int16 (dctcoef width, common/common.h:126); the
    # syntax pack is already int16 so this is usually zero-copy
    return np.ascontiguousarray(a, np.int16)


def _qp_arg(keep, qp_mb):
    if qp_mb is None:
        return ctypes.c_void_p(0)
    arr = _i32(qp_mb)
    keep.append(arr)
    return arr.ctypes.data_as(ctypes.c_void_p)


_tls = threading.local()   # per-thread buffers: slice writers run
_zero_bufs: dict = {}      # concurrently in a pool for multi-stream


def _zeros_cached(shape) -> np.ndarray:
    buf = _zero_bufs.get(shape)
    if buf is None:
        buf = np.zeros(shape, np.int16)
        _zero_bufs[shape] = buf
    return buf


def _out_buf(cap: int) -> np.ndarray:
    """Reused per-thread output buffer: an 8 MB np.zeros costs ~35 ms
    on the host — never allocate per slice."""
    bufs = getattr(_tls, "out_bufs", None)
    if bufs is None:
        bufs = _tls.out_bufs = {}
    buf = bufs.get(cap)
    if buf is None:
        buf = np.empty(cap, np.uint8)
        bufs[cap] = buf
    return buf


def _row_bits_arg(row_bits):
    """row_bits: optional np.int64 (mb_h,) out-array for cumulative
    end-of-row bit positions (per-row VBV, ratecontrol.c:599-780)."""
    if row_bits is None:
        return ctypes.c_void_p(0)
    assert row_bits.dtype == np.int64 and row_bits.flags.c_contiguous
    return row_bits.ctypes.data_as(ctypes.c_void_p)


def write_slice_i(header_bits: tuple, mb_w: int, mb_h: int, qp: int,
                  syn: dict, qp_mb=None, row_bits=None) -> bytes:
    lib = get_lib()
    header, nbits = header_bits          # header includes a partial byte
    full = len(header) - 1
    cap = mb_w * mb_h * 1024 + full + 4096
    out = _out_buf(cap)
    hdr = np.frombuffer(header, np.uint8)
    keep = []
    args = [out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
            hdr.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(full), ctypes.c_int(nbits),
            ctypes.c_int(mb_w), ctypes.c_int(mb_h), ctypes.c_int(qp)]
    for k in ("mb_type", "i16_mode", "i4_modes", "chroma_mode", "cbp_luma",
              "cbp_chroma", "nz_luma_dc", "luma_levels", "luma_dc_levels",
              "chroma_dc_levels", "chroma_ac_levels"):
        arr = _i32(syn[k])
        keep.append(arr)
        args.append(arr.ctypes.data_as(ctypes.c_void_p))
    args.append(_qp_arg(keep, qp_mb))
    args.append(_row_bits_arg(row_bits))
    n = lib.x264tpu_write_slice_i(*args)
    return out[:n].tobytes()


def write_slice_p(header_bits: tuple, mb_w: int, mb_h: int, qp: int,
                  syn: dict, qp_mb=None, n_ref: int = 1, row_bits=None):
    """Returns (payload bytes, number of P_SKIP MBs)."""
    lib = get_lib()
    header, nbits = header_bits          # header includes a partial byte
    full = len(header) - 1
    cap = mb_w * mb_h * 1024 + full + 4096
    out = _out_buf(cap)
    hdr = np.frombuffer(header, np.uint8)
    skip_count = ctypes.c_int32(0)
    keep = []
    args = [out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
            hdr.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(full), ctypes.c_int(nbits),
            ctypes.c_int(mb_w), ctypes.c_int(mb_h), ctypes.c_int(qp)]
    for k in ("mv", "cbp_luma", "cbp_chroma", "luma_levels",
              "chroma_dc_levels", "chroma_ac_levels"):
        arr = _i32(syn[k])
        keep.append(arr)
        args.append(arr.ctypes.data_as(ctypes.c_void_p))
    args.append(ctypes.byref(skip_count))
    args.append(_qp_arg(keep, qp_mb))
    args.append(_qp_arg(keep, syn.get("partition")))
    args.append(_qp_arg(keep, syn.get("mv8")))
    args.append(_qp_arg(keep, syn.get("ref")))
    args.append(ctypes.c_int(n_ref))
    args.append(_row_bits_arg(row_bits))
    n = lib.x264tpu_write_slice_p(*args)
    return out[:n].tobytes(), int(skip_count.value)


def write_slice_cabac(header: bytes, mb_w: int, mb_h: int, qp: int,
                      frame_idx: int, is_p: bool, syn: dict, qp_mb=None,
                      n_ref: int = 1, row_bits=None, res_ops=None,
                      res_off=None):
    """C++ CABAC slice body. header must be byte-aligned (the
    cabac_alignment_one_bit already written). Returns (payload, counts)
    with counts the MBs coded as [I_16x16, I_4x4, P_L0, P_SKIP, P_16x8,
    P_8x16, P_8x8]. row_bits: as in write_slice_i / _p, an optional
    np.int64 (mb_h,) out-array of cumulative end-of-row bit positions
    (x264dsp_tpu/entropy/native.py:140-146; x264_cabac_pos, so a slice
    starts at 1 bit).

    res_ops/res_off: optional device-binarized residual op stream +
    (mb_w*mb_h*27+1) per-block-slot offsets (entropy/cabac_device.py);
    when given, the writer consumes pre-binarized residual bins instead
    of re-binarizing on the host (byte-identical)."""
    lib = get_lib()
    cap = mb_w * mb_h * 1024 + len(header) + 4096
    out = _out_buf(cap)
    hdr = np.frombuffer(header, np.uint8)
    counts = np.zeros(7, np.int32)
    zeros16 = _zeros_cached((mb_h, mb_w, 16))
    zeros1 = _zeros_cached((mb_h, mb_w))
    zeros2 = _zeros_cached((mb_h, mb_w, 2))
    zeros24 = _zeros_cached((mb_h, mb_w, 2, 4))

    def get(k, fb):
        return _i32(syn[k]) if k in syn and syn[k] is not None else fb

    keep = []
    args = [out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
            hdr.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(len(header)),
            ctypes.c_int(1 if is_p else 0),
            ctypes.c_int(mb_w), ctypes.c_int(mb_h), ctypes.c_int(qp),
            ctypes.c_int(frame_idx)]
    for k, fb in (("mb_type", zeros1), ("i16_mode", zeros1),
                  ("i4_modes", zeros16), ("chroma_mode", zeros1),
                  ("cbp_luma", None), ("cbp_chroma", None),
                  ("nz_luma_dc", zeros1), ("chroma_nz_dc", zeros2),
                  ("luma_nnz", zeros16), ("chroma_nnz_ac", zeros24),
                  ("luma_levels", None), ("luma_dc_levels", zeros16),
                  ("chroma_dc_levels", None), ("chroma_ac_levels", None),
                  ("mv", zeros2)):
        arr = get(k, fb)
        keep.append(arr)
        args.append(arr.ctypes.data_as(ctypes.c_void_p))
    args.append(counts.ctypes.data_as(ctypes.c_void_p))
    args.append(_qp_arg(keep, qp_mb))
    args.append(_qp_arg(keep, syn.get("partition") if is_p else None))
    args.append(_qp_arg(keep, syn.get("mv8") if is_p else None))
    args.append(_qp_arg(keep, syn.get("ref") if is_p else None))
    args.append(ctypes.c_int(n_ref))
    args.append(_row_bits_arg(row_bits))
    if res_ops is not None and res_off is not None:
        ops_arr = np.ascontiguousarray(res_ops, np.int16)
        off_arr = np.ascontiguousarray(res_off, np.int32)
        assert off_arr.shape[0] == mb_w * mb_h * 27 + 1
        keep += [ops_arr, off_arr]
        args.append(ops_arr.ctypes.data_as(ctypes.c_void_p))
        args.append(off_arr.ctypes.data_as(ctypes.c_void_p))
    else:
        args.append(ctypes.c_void_p(0))
        args.append(ctypes.c_void_p(0))
    n = lib.x264tpu_write_slice_cabac(*args)
    return out[:n].tobytes(), counts
