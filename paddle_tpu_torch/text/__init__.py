"""Text models of the port. Counterpart of ``paddle_tpu/text``."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining, BertModel,
                   BertPooler, BertPretrainingHeads, bert_base, bert_large)

__all__ = ['BertConfig', 'BertEmbeddings', 'BertModel', 'BertPooler',
           'BertPretrainingHeads', 'BertForPretraining', 'bert_base',
           'bert_large']
