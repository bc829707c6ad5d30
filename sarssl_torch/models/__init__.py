from .common import BatchNorm, Dense, Dropout, LayerNorm
from .conformer import (ConformerBlock, ConformerEncoder, ConvModule, FeedForwardModule,
                        RelPosSelfAttention, sinusoid_position_encoding)
from .crnn import CRNN, TCRNN, BiGRU, CauCRNN, CausCnnBlock, CnnBlock, CRNNSim, GRUCell
from .decoder import EmbedDecoder
from .encoder import CNNFrontEnd, EmbedEncoder
from .sarssl import SARSSL, MCConformer, SARSSLConfig, SARSSLMultiCH
from .transformer import EncoderLayer, MultiHeadDotProductAttention, TransformerEncoder

__all__ = ["BatchNorm", "Dense", "Dropout", "LayerNorm", "ConformerBlock",
           "ConformerEncoder", "ConvModule", "FeedForwardModule", "RelPosSelfAttention",
           "sinusoid_position_encoding", "EmbedDecoder", "CNNFrontEnd", "EmbedEncoder",
           "SARSSL", "SARSSLConfig", "SARSSLMultiCH", "MCConformer", "TransformerEncoder",
           "EncoderLayer", "MultiHeadDotProductAttention", "CnnBlock", "GRUCell", "BiGRU",
           "CRNN", "CRNNSim", "TCRNN", "CausCnnBlock", "CauCRNN"]
