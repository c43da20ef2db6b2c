"""PyTorch and CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper.

The module paths mirror the JAX package's, so each counterpart is found at
the same path. The package imports torch, numpy and the standard library
only. Entry points take ``device=None``, which means CUDA, and raise when
there is no CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .nn.conf.builders import NeuralNetConfiguration  # noqa: E402
from .nn.conf.multilayer import MultiLayerConfiguration  # noqa: E402
from .nn.multilayer import MultiLayerNetwork  # noqa: E402

__all__ = ["MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "__version__"]
