"""The benchmark of the PyTorch/CUDA encoder x264dsp_tpu_torch (see
README.md). Run one cell with ``python -m portbench.run``."""
