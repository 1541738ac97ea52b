"""Input feeding of the port. Counterpart of ``paddle_tpu/io``; this
version has the device prefetcher ``engine.fit`` feeds its steps with
(``prefetch``). The DataLoader and datasets are a later slice."""
from .prefetch import DevicePrefetcher

__all__ = ['DevicePrefetcher']
