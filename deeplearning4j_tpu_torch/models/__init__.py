"""Model configurations of the port."""
from .char_rnn import char_rnn_lstm
from .lenet import lenet_mnist
from .resnet import resnet18, resnet50
from .transformer import transformer_lm

__all__ = ["char_rnn_lstm", "lenet_mnist", "resnet18", "resnet50",
           "transformer_lm"]
