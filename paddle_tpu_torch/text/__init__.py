"""Text models and datasets of the port. Counterpart of
``paddle_tpu/text``: BERT, ERNIE, GPT, the Transformer seq2seq, the
layer zoo of ``layers`` (the recurrent cells and drivers, the
Transformer family of the pre/post-process commands, the CRF layers and
``SequenceTagging``), ``LSTMLanguageModel``, ``SkipGram``, the
``Tokenizer`` and ``datasets`` (whose classes are also here, as in the
reference, with ``Sentiment`` also named ``MovieReviews``)."""
from . import datasets, layers
from .._native.tokenizer import Tokenizer
from .bert import (BertConfig, BertEmbeddings, BertForPretraining, BertModel,
                   BertPooler, BertPretrainingHeads, bert_base, bert_large)
from .datasets import (MQ2007, WMT14, WMT16, Conll05st, Imdb, Imikolov,
                       Movielens, Sentiment, UCIHousing)
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieModel,
                    ernie_knowledge_mask, ernie_mask_batch)
from .gpt import GPTConfig, GPTModel, gpt_small
from .layers import (FFN, GRU, LSTM, RNN, BasicGRUCell, BasicLSTMCell,
                     BeamSearchDecoder, BidirectionalGRU, BidirectionalLSTM,
                     BidirectionalRNN, CNNEncoder, Conv1dPoolLayer,
                     CRFDecoding, DynamicDecode, LinearChainCRF,
                     MultiHeadAttention, RNNCell, SequenceTagging,
                     StackedGRUCell, StackedLSTMCell, StackedRNNCell,
                     TransformerBeamSearchDecoder, TransformerCell,
                     TransformerDecoder, TransformerDecoderLayer,
                     TransformerEncoder, TransformerEncoderLayer)
from .lm import LSTMLanguageModel
from .seq2seq import Seq2SeqTransformer
from .word2vec import SkipGram, Word2Vec

MovieReviews = Sentiment

__all__ = ['BertConfig', 'BertEmbeddings', 'BertModel', 'BertPooler',
           'BertPretrainingHeads', 'BertForPretraining', 'bert_base',
           'bert_large', 'ErnieConfig', 'ErnieModel', 'ErnieForPretraining',
           'ernie_knowledge_mask', 'ernie_mask_batch', 'GPTConfig',
           'GPTModel', 'gpt_small', 'Seq2SeqTransformer', 'datasets',
           'Conll05st', 'Imdb', 'Imikolov', 'Movielens', 'MQ2007',
           'Sentiment', 'MovieReviews', 'UCIHousing', 'WMT14', 'WMT16',
           'SkipGram', 'Word2Vec', 'LSTMLanguageModel', 'Tokenizer',
           *(n for n in layers.__all__ if n != 'PrePostProcessLayer')]
