"""Network configuration: the JAX package's JSON schema, read and written,
and the builder DSL that writes it."""
from .builders import NeuralNetConfiguration
from .graphconf import ComputationGraphConfiguration, GraphBuilder
from .inputs import InputType
from .multilayer import GlobalConf, LayerConf, MultiLayerConfiguration

__all__ = ["ComputationGraphConfiguration", "GlobalConf", "GraphBuilder",
           "InputType", "LayerConf", "MultiLayerConfiguration",
           "NeuralNetConfiguration"]
