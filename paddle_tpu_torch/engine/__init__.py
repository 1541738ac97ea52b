"""The train step every frontend shares, and the eager loop over it.
Counterpart of ``paddle_tpu/engine``: ``build_train_step`` and ``fit``."""
from .builder import DeviceLoss, StepResult, TrainStep, build_train_step
from .loop import adopt_optimizer_state, fit, write_back_state

__all__ = ['build_train_step', 'TrainStep', 'StepResult', 'DeviceLoss',
           'fit', 'write_back_state', 'adopt_optimizer_state']
