"""Hand-written CUDA kernels, each beside its plain torch version.

A wrapper launches its kernel on a CUDA tensor (building ``csrc/`` on first
use) and runs the plain version on a CPU tensor; the plain version is what
the CPU tests hold against the reference's Pallas kernel in interpret mode.
"""

from spartan_tpu_torch.backend.kernels import fused_reduce
