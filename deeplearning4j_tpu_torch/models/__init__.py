"""Model configurations of the port."""
from .alexnet import alexnet
from .char_rnn import char_rnn_lstm
from .googlenet import googlenet
from .lenet import lenet_mnist
from .resnet import resnet18, resnet50
from .transformer import moe_transformer_lm, transformer_lm
from .vgg import vgg16

__all__ = ["alexnet", "char_rnn_lstm", "googlenet", "lenet_mnist",
           "moe_transformer_lm", "resnet18", "resnet50", "transformer_lm",
           "vgg16"]
