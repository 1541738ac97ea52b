"""Text datasets of the port. Counterpart of
``paddle_tpu/text/datasets`` (``Imdb``, ``Imikolov``, ``Movielens``,
``UCIHousing``, ``WMT14``, ``WMT16``, ``Conll05st``, ``MQ2007``,
``Sentiment``): local files under ``PADDLE_TPU_DATA_HOME`` when present,
else the reference's synthetic sets; nothing is downloaded.
"""
from .synthetic import (Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16,
                        Conll05st, MQ2007, Sentiment)
