"""K1's work: the 16x16 SAD surface of every macroblock at every full-pel
offset within +-R (the DIA and HEX walks' input when the P analysis
reads no 8x8 quadrant sums). Counted as chip_smoke.py's phase 2 counts
it: the int32 source frame and the int32 search strips read once, one
int32 sum per offset written once; the operations are the packed
4-pixel sums (S H W (2R+1)^2 / 4) at the int32 rate."""

ROOFLINE = "sad"
DEVICE_KERNELS = ("sad_surface16_kernel",)


def sad_inputs(S: int, W: int, H: int, R: int) -> int:
    mb_w, mb_h = W // 16, H // 16
    fenc = 4 * S * H * W
    strips = 4 * S * mb_h * (16 + 2 * R) * (16 * mb_w + 2 * R)
    return fenc + strips


def uses_quadrants(r) -> bool:
    """The port reads K4's 8x8 quadrant sums for the partitions and for
    the UMH and ESA searches, K1's surface otherwise."""
    p = r.config["param"]
    return bool(p.get("analyse.inter")) or p.get("analyse.i_me_method") in (
        "ME_UMH", "ME_ESA")


def k1(S: int, W: int, H: int, R: int):
    """(bytes, int32 operations) of one launch."""
    n = 2 * R + 1
    out = 4 * S * (H // 16) * (W // 16) * n * n
    return sad_inputs(S, W, H, R) + out, S * H * W * n * n // 4


def work(r):
    """(bytes, int32 operations) per P slot (one launch), or None."""
    return None if uses_quadrants(r) else k1(r.S, r.W, r.H, r.me_range)
