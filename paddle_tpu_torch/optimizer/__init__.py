"""Optimizers of the port. Counterpart of ``paddle_tpu/optimizer``: the
optimizers, the learning-rate schedulers (``lr``, also under the
2.0-beta path ``lr_scheduler``), the flat-buffer ``FlatFusedUpdate`` and
the fluid-era ``*Optimizer`` and ``*LR`` aliases. Not ported yet:
``extras`` (EMA, LookAhead, ModelAverage, the Recompute and Pipeline
wrappers)."""
from . import lr
from .fused import FlatFusedUpdate
from .lr import *  # noqa: F401,F403
from .lr import __all__ as _lr_all
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DecayedAdagrad, DecayedAdagradOptimizer, Dpsgd,
                        DpsgdOptimizer, Ftrl, Lamb, LarsMomentum, Momentum,
                        Optimizer, RMSProp)

# -- 1.8 *Optimizer aliases + 2.0-beta *LR scheduler names -------------------
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdadeltaOptimizer = Adadelta
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LambOptimizer = Lamb
LarsMomentumOptimizer = LarsMomentum
SGDOptimizer = SGD

from .lr import (NoamDecay as NoamLR,  # noqa: E402
                 PiecewiseDecay as PiecewiseLR,
                 NaturalExpDecay as NaturalExpLR,
                 InverseTimeDecay as InverseTimeLR,
                 PolynomialDecay as PolynomialLR,
                 LinearWarmup as LinearLrWarmup,
                 ExponentialDecay as ExponentialLR,
                 MultiStepDecay as MultiStepLR,
                 StepDecay as StepLR,
                 LambdaDecay as LambdaLR,
                 ReduceOnPlateau as ReduceLROnPlateau,
                 CosineAnnealingDecay as CosineAnnealingLR)
from . import lr_scheduler  # noqa: E402
from .lr_scheduler import _LRScheduler  # noqa: E402,F401

__all__ = (['Optimizer', 'SGD', 'Momentum', 'Adam', 'AdamW', 'Adamax',
            'Adadelta', 'Adagrad', 'RMSProp', 'Lamb', 'LarsMomentum', 'Ftrl',
            'DecayedAdagrad', 'DecayedAdagradOptimizer', 'Dpsgd',
            'DpsgdOptimizer', 'FlatFusedUpdate', 'lr', 'lr_scheduler',
            'MomentumOptimizer', 'AdagradOptimizer', 'AdadeltaOptimizer',
            'AdamOptimizer', 'AdamaxOptimizer', 'RMSPropOptimizer',
            'FtrlOptimizer', 'LambOptimizer', 'LarsMomentumOptimizer',
            'SGDOptimizer', 'NoamLR', 'PiecewiseLR', 'NaturalExpLR',
            'InverseTimeLR', 'PolynomialLR', 'LinearLrWarmup',
            'ExponentialLR', 'MultiStepLR', 'StepLR', 'LambdaLR',
            'ReduceLROnPlateau', 'CosineAnnealingLR'] + list(_lr_all))
