"""The 2.0-beta ``optimizer.lr_scheduler`` module path. Counterpart of
``paddle_tpu/optimizer/lr_scheduler.py``: the schedulers of ``lr.py``
under a second import path, with the base class also as
``_LRScheduler``."""
from .lr import *  # noqa: F401,F403
from .lr import LRScheduler, __all__ as _lr_all

_LRScheduler = LRScheduler

__all__ = list(_lr_all) + ['_LRScheduler']
