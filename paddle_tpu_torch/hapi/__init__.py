"""The high-level API. Counterpart of ``paddle_tpu/hapi``: ``Model``,
``callbacks``, ``summary``, ``flops``, ``ProgressBar``."""
from . import callbacks
from .callbacks import Callback, ModelCheckpoint, ProgBarLogger
from .model import Model
from .model_summary import flops, summary
from .progressbar import ProgressBar

__all__ = ['Model', 'callbacks', 'summary', 'flops', 'Callback',
           'ModelCheckpoint', 'ProgBarLogger', 'ProgressBar']
