"""Execution backend: region evaluator and hand-written CUDA kernels."""

from spartan_tpu_torch.backend import evaluator
