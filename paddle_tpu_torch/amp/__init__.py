"""Automatic mixed precision. Counterpart of ``paddle_tpu/amp/__init__.py``
(``auto_cast`` / ``amp_guard``, ``maybe_cast_for``, ``GradScaler``,
``decorate``, ``AutoMixedPrecisionLists``, ``white_list``, ``black_list``).

The reference's semantics, not ``torch.autocast``'s: ``auto_cast`` pushes
a state on a thread-local stack, and only the functionals that ask
``maybe_cast_for`` change dtype — ``nn.functional.linear`` here, as
``F.linear`` (and ``conv2d``, not ported) in the reference. Under ``O1`` a
white-listed op (``linear`` asks as ``'matmul'``) gets its floating inputs
cast to the amp dtype; under ``O2`` every op not black-listed does. What
the cast outputs meet downstream promotes as the reference's ``jnp``
promotes (``nn/functional/norm.py``, ``text/bert.py``). The casts are
``Tensor.to``: differentiable, so gradients arrive in each parameter's own
dtype.

``GradScaler`` keeps the reference's dynamic policy: the scale halves
(``decr_ratio``) after ``decr_every_n_nan_or_inf`` bad steps in a row,
never below 1.0, and doubles (``incr_ratio``) after
``incr_every_n_steps`` good ones. Its eager ``unscale_`` / ``step`` /
``minimize`` read the found-inf flag on the host, as the reference's do;
``engine.build_train_step(scaler=)`` runs the same policy on the device
and never waits for it (``TrainStep.sync`` brings the host object up to
date). ``decorate(level='O2')`` casts the models' floating parameters and
buffers to the dtype and does nothing else: the reference's has no master
weights (the flat fp32 master of ``optimizer.FlatFusedUpdate`` is the
port's mixed-precision recipe with them).
"""
import contextlib
import threading

import torch

__all__ = ['auto_cast', 'amp_guard', 'GradScaler', 'decorate',
           'white_list', 'black_list', 'AutoMixedPrecisionLists',
           'maybe_cast_for', 'amp_enabled']

# mirrors fluid/contrib/mixed_precision/fp16_lists.py
white_list = {'conv2d', 'matmul', 'mul', 'einsum', 'linear', 'bmm'}
black_list = {'exp', 'square', 'log', 'mean', 'sum', 'cos_sim', 'softmax',
              'softmax_with_cross_entropy',
              'sigmoid_cross_entropy_with_logits', 'cross_entropy',
              'layer_norm', 'batch_norm'}

_DTYPES = {'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
           'float16': torch.float16, 'fp16': torch.float16,
           'half': torch.float16, 'float32': torch.float32,
           'fp32': torch.float32}

_tls = threading.local()


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp: unknown dtype {dtype!r}")
    return _DTYPES[dtype]


def _amp_state():
    if not hasattr(_tls, 'stack'):
        _tls.stack = []
    return _tls.stack


def amp_enabled():
    """The innermost ``auto_cast`` state of this thread, or None."""
    s = _amp_state()
    return s[-1] if s else None


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level='O1', dtype='bfloat16'):
    state = {'enable': enable, 'dtype': _dtype(dtype),
             'white': set(white_list) | set(custom_white_list or ()),
             'black': set(black_list) | set(custom_black_list or ()),
             'level': level} if enable else None
    _amp_state().append(state)
    try:
        yield
    finally:
        _amp_state().pop()


amp_guard = auto_cast


def maybe_cast_for(op_name, *values):
    """The inputs of ``op_name`` as the innermost ``auto_cast`` wants them:
    floating tensors cast to the amp dtype under O2 (unless black-listed)
    or for a white-listed op; everything else as given."""
    st = amp_enabled()
    if not st or not st['enable']:
        return values
    if op_name in st['black']:
        return values
    if st['level'] == 'O2' or op_name in st['white']:
        dt = st['dtype']
        return tuple(v.to(dt) if isinstance(v, torch.Tensor)
                     and v.is_floating_point() else v for v in values)
    return values


class GradScaler:
    """Dynamic loss scaling (the reference's policy, bit for bit)."""

    def __init__(self, enable=True, init_loss_scaling=2.**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient of ``optimizer``'s parameters by 1 /
        scale and note whether any is non-finite (read on the host)."""
        if not self._enable:
            return
        grads = [p.grad for _, p in optimizer._parameters or ()
                 if p.grad is not None]
        inv = 1.0 / self._scale
        found = False
        if grads:
            torch._foreach_mul_(grads, inv)
            found = bool(torch.stack([~torch.isfinite(g).all()
                                      for g in grads]).any())
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def mark_found_inf(self):
        """A NaN guard (``resilience.NanGuard``) reports a poisoned step
        that never reached ``unscale_``/``step``: the scale backs off
        through the same decrement path a bad gradient takes."""
        if not self._enable:
            return
        self._found_inf = True
        self.update()

    def update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {'scale': self._scale, 'good': self._good_steps,
                'bad': self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get('scale', self._scale)
        self._good_steps = sd.get('good', 0)
        self._bad_steps = sd.get('bad', 0)


def decorate(optimizer=None, models=None, level='O1', dtype='bfloat16',
             init_loss_scaling=2.**15, use_dynamic_loss_scaling=True,
             **kwargs):
    """At ``O2`` cast every floating parameter and buffer of ``models`` (a
    module or a list of them) to ``dtype``, in place; at ``O1`` nothing.
    -> ``optimizer``, or ``(models, optimizer)`` when models are given."""
    if level == 'O2' and models is not None:
        dt = _dtype(dtype)
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(dtype=dt)
    if models is None:
        return optimizer
    return models, optimizer


class AutoMixedPrecisionLists:
    """The op-name white / black / black-varnames triple
    (``fp16_lists.AutoMixedPrecisionLists``): the builtin lists adjusted
    by the custom sets, a custom-white op leaving the black list and vice
    versa."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        cw = set(custom_white_list or ())
        cb = set(custom_black_list or ())
        both = cw & cb
        if both:
            raise ValueError(
                "custom_white_list and custom_black_list both contain "
                "%s" % sorted(both))
        self.white_list = (set(white_list) | cw) - cb
        self.black_list = (set(black_list) | cb) - cw
        self.black_varnames = set(custom_black_varnames or ())
