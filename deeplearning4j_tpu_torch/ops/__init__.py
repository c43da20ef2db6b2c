"""Tensor ops of the port: activations, int8 quantization, the paged KV
gather and flash attention. The CUDA kernels under ``csrc/`` are built at
first use (``ops/_cuda.py``), never at import."""
