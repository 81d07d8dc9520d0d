"""The motion-compensation windows' share of their roofline (K2a and
K2b): kernels/ family "windows"."""

from portbench import roofline


def read(r):
    s = roofline.share(r, "windows")
    return None if s is None else s[0]
