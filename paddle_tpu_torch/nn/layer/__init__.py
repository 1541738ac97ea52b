"""Layers of the port. Counterpart of ``paddle_tpu/nn/layer``."""
from . import (activation, common, container, conv, distance, loss, norm,
               pooling, rnn, transformer)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import LayerList, Sequential
from .conv import *  # noqa: F401,F403
from .distance import PairwiseDistance
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = sorted({*activation.__all__, *common.__all__, *conv.__all__,
                  *loss.__all__, *norm.__all__, *pooling.__all__,
                  'LayerList', 'Sequential', 'PairwiseDistance',
                  *rnn.__all__,
                  *transformer.__all__})
