"""NaN/Inf step guard: skip poisoned updates instead of corrupting the run.
Counterpart of ``paddle_tpu/resilience/nanguard.py`` (``NanGuard``,
``NanStepError``), with the same counters, warnings and abort at the
streak limit.

A single non-finite loss poisons every parameter the moment the update
applies; the guard checks the loss and skips the step. It cooperates with
the dynamic ``amp.GradScaler``: a skipped step is reported as a found-inf
event, so the loss scale backs off through the scaler's own decrement
path. ``engine.build_train_step(nan_guard=True)`` keeps the counters on the
device and never waits for it; ``TrainStep.sync`` hands them to
``absorb_device_counts``.

Left out: the reference's telemetry counters and events and its flight
dump on abort; they come with the training side's telemetry (ROADMAP.md,
Queue 1 item 4b).
"""
import warnings

import numpy as np
import torch

__all__ = ['NanGuard', 'NanStepError']


class NanStepError(RuntimeError):
    """Raised when ``max_consecutive_skips`` poisoned steps occur in a row —
    at that point the run is diverging, not hitting a transient spike."""


class NanGuard:
    def __init__(self, max_consecutive_skips=25, scaler=None, verbose=True):
        self.max_consecutive_skips = max_consecutive_skips
        self.skipped_steps = 0
        self.consecutive_skips = 0
        self.total_steps = 0
        self._scaler = scaler
        self._verbose = verbose

    def attach_scaler(self, scaler):
        """Report skipped steps to a GradScaler so dynamic loss scaling
        decays on guard-skipped updates too."""
        self._scaler = scaler
        return self

    @staticmethod
    def is_finite(value):
        """True iff every element of ``value`` (tensor, array or number) is
        finite. Reads it on the host (a device tensor is waited for)."""
        if isinstance(value, torch.Tensor):
            return bool(torch.isfinite(value).all())
        return bool(np.isfinite(np.asarray(value)).all())

    def _abort(self, consecutive):
        raise NanStepError(
            "NanGuard: %d consecutive non-finite steps (limit %d) — "
            "the run is diverging; lower the learning rate or inspect "
            "the data pipeline" % (consecutive, self.max_consecutive_skips))

    def check(self, loss):
        """Record one step; returns True when the step must be SKIPPED."""
        self.total_steps += 1
        if self.is_finite(loss):
            self.consecutive_skips = 0
            return False
        self.skipped_steps += 1
        self.consecutive_skips += 1
        if self._scaler is not None and self._scaler.is_enable():
            self._scaler.mark_found_inf()
        if self._verbose:
            warnings.warn(
                "NanGuard: non-finite loss at step %d — skipping the "
                "update (%d skipped so far, %d consecutive)"
                % (self.total_steps, self.skipped_steps,
                   self.consecutive_skips))
        if self.consecutive_skips >= self.max_consecutive_skips:
            self._abort(self.consecutive_skips)
        return True

    def absorb_device_counts(self, total_steps, skipped_steps, consecutive,
                             mark_scaler=True, raise_on_limit=True,
                             peak_consecutive=None):
        """Adopt the counters the train step keeps on the device.

        Warns as :meth:`check` does for the steps skipped since the last
        reconcile, reports them to an attached ``GradScaler`` unless the
        step already ran the scaler's update on the device
        (``mark_scaler=False``), and raises ``NanStepError`` at the limit
        — judged on ``peak_consecutive`` (the longest streak since the last
        reconcile), so a limit-length streak that ended before this sync
        still aborts, as the eager guard would have mid-streak. Returns
        the number of newly observed skips."""
        new_skips = max(int(skipped_steps) - self.skipped_steps, 0)
        self.total_steps = int(total_steps)
        self.skipped_steps = int(skipped_steps)
        self.consecutive_skips = int(consecutive)
        if new_skips:
            if mark_scaler and self._scaler is not None and \
                    self._scaler.is_enable():
                for _ in range(new_skips):
                    self._scaler.mark_found_inf()
            if self._verbose:
                warnings.warn(
                    "NanGuard: %d non-finite step(s) skipped on the device "
                    "by step %d (%d skipped so far, %d consecutive)"
                    % (new_skips, self.total_steps, self.skipped_steps,
                       self.consecutive_skips))
        worst = max(self.consecutive_skips,
                    int(peak_consecutive
                        if peak_consecutive is not None else 0))
        if raise_on_limit and worst >= self.max_consecutive_skips:
            self._abort(worst)
        return new_skips

    def state_dict(self):
        return {'skipped_steps': self.skipped_steps,
                'consecutive_skips': self.consecutive_skips,
                'total_steps': self.total_steps}

    def load_state_dict(self, sd):
        self.skipped_steps = int(sd.get('skipped_steps', 0))
        self.consecutive_skips = int(sd.get('consecutive_skips', 0))
        self.total_steps = int(sd.get('total_steps', 0))
