"""K4's work: the four 8x8-quadrant SAD surfaces of every macroblock at
every full-pel offset within +-R (the partition analysis's and the UMH /
ESA searches' input). As chip_smoke.py's phase 2: K1's inputs, four
int32 sums per offset written once, the same packed sums as K1."""

from portbench.kernels import sad16

ROOFLINE = "sad"
DEVICE_KERNELS = ("sad_surfaces_8x8_kernel",)


def k4(S: int, W: int, H: int, R: int):
    """(bytes, int32 operations) of one launch."""
    n = 2 * R + 1
    out = 16 * S * (H // 16) * (W // 16) * n * n
    return sad16.sad_inputs(S, W, H, R) + out, S * H * W * n * n // 4


def work(r):
    """(bytes, int32 operations) per P slot (one launch), or None."""
    if not sad16.uses_quadrants(r):
        return None
    return k4(r.S, r.W, r.H, r.me_range)
