"""The SAD surfaces' share of their roofline (K1, or K4 where the P
analysis reads quadrant sums): kernels/ family "sad"."""

from portbench import roofline


def read(r):
    s = roofline.share(r, "sad")
    return None if s is None else s[0]
