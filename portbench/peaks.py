"""Published peaks of the cards the benchmark runs on, by the name
torch.cuda.get_device_name() gives.

H100 SXM (NVIDIA's data sheet, at the 700 W limit): HBM3 at 3.35 TB/s,
and int32 operations outside the tensor cores at 132 SMs x 64 lanes x
1.98 GHz (half the float32 rate of 67 TFLOP/s). K1 and K4 sum four byte
differences per VABSDIFF4.U8.ACC, issued at the int32 rate, so their
operations are packed sums at this rate (chip_smoke.py:158-163).
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12,
                              "int32_ops_s": 132 * 64 * 1.98e9},
}


def of(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def least_seconds(peak: dict, nbytes: float, ops: float):
    """(seconds, "bytes" or "operations"): the least time the work needs
    on the card, the larger of its two terms."""
    t_b = nbytes / peak["hbm_bytes_s"]
    t_o = ops / peak["int32_ops_s"]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
