"""Model configurations of the port."""
from .char_rnn import char_rnn_lstm
from .lenet import lenet_mnist
from .transformer import transformer_lm

__all__ = ["char_rnn_lstm", "lenet_mnist", "transformer_lm"]
