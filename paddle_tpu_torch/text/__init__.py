"""Text models and datasets of the port. Counterpart of
``paddle_tpu/text``: BERT, ERNIE, GPT, the Transformer seq2seq and
``datasets`` (whose classes are also here, as in the reference, with
``Sentiment`` also named ``MovieReviews``)."""
from . import datasets
from .bert import (BertConfig, BertEmbeddings, BertForPretraining, BertModel,
                   BertPooler, BertPretrainingHeads, bert_base, bert_large)
from .datasets import (MQ2007, WMT14, WMT16, Conll05st, Imdb, Imikolov,
                       Movielens, Sentiment, UCIHousing)
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieModel,
                    ernie_knowledge_mask, ernie_mask_batch)
from .gpt import GPTConfig, GPTModel, gpt_small
from .seq2seq import Seq2SeqTransformer

MovieReviews = Sentiment

__all__ = ['BertConfig', 'BertEmbeddings', 'BertModel', 'BertPooler',
           'BertPretrainingHeads', 'BertForPretraining', 'bert_base',
           'bert_large', 'ErnieConfig', 'ErnieModel', 'ErnieForPretraining',
           'ernie_knowledge_mask', 'ernie_mask_batch', 'GPTConfig',
           'GPTModel', 'gpt_small', 'Seq2SeqTransformer', 'datasets',
           'Conll05st', 'Imdb', 'Imikolov', 'Movielens', 'MQ2007',
           'Sentiment', 'MovieReviews', 'UCIHousing', 'WMT14', 'WMT16']
