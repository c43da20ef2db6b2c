"""Model configurations of the port."""
from .transformer import transformer_lm

__all__ = ["transformer_lm"]
