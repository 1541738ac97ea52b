"""The train step every frontend shares. Counterpart of
``paddle_tpu/engine``; this version has ``build_train_step``."""
from .builder import DeviceLoss, StepResult, TrainStep, build_train_step

__all__ = ['build_train_step', 'TrainStep', 'StepResult', 'DeviceLoss']
