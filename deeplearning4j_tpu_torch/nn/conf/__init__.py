"""Network configuration: the JAX package's JSON schema, read and written,
and the builder DSL that writes it."""
from .builders import NeuralNetConfiguration
from .inputs import InputType
from .multilayer import GlobalConf, LayerConf, MultiLayerConfiguration

__all__ = ["GlobalConf", "InputType", "LayerConf", "MultiLayerConfiguration",
           "NeuralNetConfiguration"]
