"""Model configurations of the port."""
from .char_rnn import char_rnn_lstm
from .transformer import transformer_lm

__all__ = ["char_rnn_lstm", "transformer_lm"]
