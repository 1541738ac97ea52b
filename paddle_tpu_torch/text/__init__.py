"""Text models of the port. Counterpart of ``paddle_tpu/text``."""
from .bert import (BertConfig, BertEmbeddings, BertModel, BertPooler,
                   bert_base, bert_large)

__all__ = ['BertConfig', 'BertEmbeddings', 'BertModel', 'BertPooler',
           'bert_base', 'bert_large']
