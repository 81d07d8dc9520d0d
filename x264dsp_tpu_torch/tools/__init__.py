"""Measurement helpers for the port: the main path's settings and clip
(mainpath.py), the per-slot profiler
(python -m x264dsp_tpu_torch.tools.profile_slot), the A/B timer of the
redesigned kernels (kernel_ab.py, run as a file) and the card's
packed-SAD rate (python -m x264dsp_tpu_torch.tools.sad_rate)."""
