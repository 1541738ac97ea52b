"""Progress bar. The port's own copy of ``paddle_tpu/hapi/progressbar.py``,
timed with ``time.perf_counter`` (the reference's ``Stopwatch`` belongs to
its ``observability`` package, which the port does not have yet)."""
import sys
import time

__all__ = ['ProgressBar']


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, start=True,
                 file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self.file = file
        self._values = {}
        self._t0 = time.perf_counter()
        self._last_update = 0

    def _elapsed(self):
        return time.perf_counter() - self._t0

    def update(self, current_num, values=None):
        if values:
            for k, v in values:
                self._values[k] = v
        if self._verbose == 0:
            return
        info = ' - '.join(f"{k}: {v:.4f}" if isinstance(v, float) else
                          f"{k}: {v}" for k, v in self._values.items())
        if self._num:
            bar_len = int(self._width * current_num / self._num)
            bar = '=' * bar_len + '.' * (self._width - bar_len)
            msg = f"\rstep {current_num}/{self._num} [{bar}] {info}"
        else:
            msg = f"\rstep {current_num} {info}"
        self.file.write(msg)
        if self._num and current_num >= self._num:
            self.file.write(f" - {self._elapsed():.0f}s\n")
        self.file.flush()
        self._last_update = self._elapsed()

    def start(self):
        self._t0 = time.perf_counter()
