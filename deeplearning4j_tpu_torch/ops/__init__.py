"""Tensor ops of the port: activations, losses, the fused softmax
cross-entropy, int8 quantization, the paged KV gather and flash attention
(forward and backward). The CUDA kernels under ``csrc/`` are built at first
use (``ops/_cuda.py``), never at import."""
from .activations import ACTIVATIONS, get_activation
from .losses import LOSSES, get_loss

__all__ = ["ACTIVATIONS", "LOSSES", "get_activation", "get_loss"]
