"""blink_torch — the PyTorch and CUDA port of blink for NVIDIA Hopper.

`blink` (src/blink, JAX on a TPU) is the reference this package is tested
against. Plain tensor code is torch; each TPU kernel on a ported path has a
hand-written CUDA kernel in csrc/, built with nvcc at first use, beside a
plain torch version that the CPU path runs.
"""
import torch

__version__ = "0.1.0"

# On the CPU, torch's float sqrt, sin, cos, exp and log call MKL's vector
# math inside the intra-op thread pool. When several threads enter it for
# the first time in a process at once, one thread's share of that call can
# come out wrong by up to 2^-12. One call on one thread first lets MKL set
# itself up (tests/test_torch_path.py::test_first_cpu_math_call_is_exact).
torch.sqrt(torch.ones(1))
