"""Measurement helpers for the port: the main path's settings and clip
(mainpath.py) and the per-slot profiler
(python -m x264dsp_tpu_torch.tools.profile_slot)."""
