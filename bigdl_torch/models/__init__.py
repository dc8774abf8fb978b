"""Model zoo: LeNet-5, ResNet, Inception-v1 and BN-Inception, AlexNet,
VGG, the text CNN, TransformerLM with KV-cache decoding, SimpleRNN, the
PTB LSTM language model, the MNIST autoencoder, the TreeLSTM sentiment
model, the Vision Transformer and Wide & Deep."""

from .alexnet import AlexNet
from .autoencoder import Autoencoder
from .decode import beam_generate, cached_generate, init_kv_cache
from .inception import (Inception_Layer_v1, Inception_Layer_v2,
                        Inception_v1, Inception_v1_NoAuxClassifier,
                        Inception_v2, Inception_v2_NoAuxClassifier)
from .lenet import LeNet5, lenet5
from .resnet import ResNet, ShortcutType
from .rnn import PTBModel, SimpleRNN
from .textclassifier import TextClassifier
from .transformer_lm import (PositionalEmbedding, TransformerBlock,
                             TransformerLM, greedy_generate, sample_next)
from .treelstm_sentiment import TreeLSTMSentiment, encode_tree
from .vgg import Vgg_16, Vgg_19, VggForCifar10
from .vit import ViT
from .widedeep import WideDeep

__all__ = ["TransformerLM", "TransformerBlock", "PositionalEmbedding",
           "greedy_generate", "sample_next", "cached_generate",
           "beam_generate", "init_kv_cache", "ResNet", "ShortcutType",
           "LeNet5", "lenet5", "SimpleRNN", "PTBModel", "Autoencoder",
           "AlexNet", "Inception_Layer_v1", "Inception_Layer_v2",
           "Inception_v1", "Inception_v1_NoAuxClassifier", "Inception_v2",
           "Inception_v2_NoAuxClassifier", "TextClassifier",
           "TreeLSTMSentiment", "encode_tree", "Vgg_16", "Vgg_19",
           "VggForCifar10", "ViT", "WideDeep"]
