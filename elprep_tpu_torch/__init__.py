"""elprep_tpu_torch: the PyTorch/CUDA port of elprep_tpu.

The same elPrep v5.1.3-compatible pipeline as ``elprep_tpu``, for an
NVIDIA H100: host parsing, filtering and HaplotypeCaller logic are the
JAX package's own host code, carried over; the device work runs as
PyTorch ops and hand-written Hopper kernels (``csrc/``). Entry points
run on ``cuda`` unless the caller asks for the CPU (``device=`` on
library functions, ``ELPREP_TPU_TORCH_DEVICE`` for the CLI).

This package imports neither ``jax`` nor ``elprep_tpu``.
"""

__version__ = "0.1.0"
