"""Network configuration: the JAX package's JSON schema, read and written."""
from .multilayer import GlobalConf, InputType, LayerConf, MultiLayerConfiguration

__all__ = ["GlobalConf", "InputType", "LayerConf", "MultiLayerConfiguration"]
