"""K2a's and K2b's work: each macroblock's motion-compensation windows,
cut from the padded reference planes (chip_smoke.py's phase 2). K2a
reads the four int32 quarter-pel planes (full, h, v, hv; padded by 32 on
each side) once and writes four 56x56 uint8 windows per macroblock (16
+ 2 x 20 margin); K2b, launched for u and for v, reads one int32 chroma
plane (padded by 16) and writes one 32x32 uint8 window per macroblock.
No arithmetic: bound by bytes."""

ROOFLINE = "windows"
DEVICE_KERNELS = ("luma_windows_kernel", "chroma_windows_kernel")
PAD, WIN_L, WIN_C = 32, 56, 32


def k2a(S: int, W: int, H: int) -> int:
    """Bytes of one K2a launch."""
    n_mb = (W // 16) * (H // 16)
    planes = 4 * S * 4 * (H + 2 * PAD) * (W + 2 * PAD)
    return planes + S * n_mb * 4 * WIN_L ** 2


def k2b(S: int, W: int, H: int) -> int:
    """Bytes of one K2b launch (one chroma plane)."""
    n_mb = (W // 16) * (H // 16)
    return 4 * S * (H // 2 + PAD) * (W // 2 + PAD) + S * n_mb * WIN_C ** 2


def work(r):
    """(bytes, operations) per P slot: one K2a and two K2b launches."""
    return k2a(r.S, r.W, r.H) + 2 * k2b(r.S, r.W, r.H), 0
