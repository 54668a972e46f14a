"""blink_torch — the PyTorch and CUDA port of blink for NVIDIA Hopper.

`blink` (src/blink, JAX on a TPU) is the reference this package is tested
against. Plain tensor code is torch; each TPU kernel on a ported path has a
hand-written CUDA kernel in csrc/, built with nvcc at first use, beside a
plain torch version that the CPU path runs.
"""

__version__ = "0.1.0"
