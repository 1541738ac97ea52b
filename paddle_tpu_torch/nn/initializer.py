"""Parameter initializers and ``ParamAttr``. Counterpart of
``paddle_tpu/nn/initializer/__init__.py`` (``Constant``, ``Uniform``,
``Normal``, ``TruncatedNormal``, ``XavierUniform`` / ``XavierNormal``,
``KaimingUniform`` / ``KaimingNormal``, ``Assign``, ``Bilinear``, the
fluid-era aliases, ``calculate_gain``, ``_fans``,
``set_global_initializer``, ``ParamAttr``).

An initializer is called as ``init(shape, dtype=None, device=None,
generator=None)`` -> a tensor of ``shape`` on ``device`` (the
generator's, else the CUDA device) in the reference's layout (a
``Linear`` weight is (in, out) there; the layer transposes it into its
(out, in) weight, so ``_fans`` and ``Assign`` see what they see in the
reference). Random draws come from ``generator``, an explicit
``torch.Generator`` on ``device`` (the layer's; the device's default
generator when it is None); they follow the reference's distributions and
formulas, not its bits (JAX's generator is another stream).
``TruncatedNormal`` draws N(0, 1) cut at +-2 (``torch.nn.init.trunc_normal_``)
then scales and shifts, as the reference does.

``create_parameter`` is the reference's ``Layer.create_parameter`` for the
port's layers (``Linear``, ``Embedding``, ``LayerNorm``, ``RMSNorm`` and
the transformer layers through their ``Linear``s): the ``ParamAttr``'s
initializer, else the layer's own default, else (biases, and weights
without a default) the global initializer of ``set_global_initializer``,
else zeros for a bias and ``XavierUniform`` for a weight.

``ParamAttr`` carries ``name``, ``initializer``, ``learning_rate``,
``regularizer``, ``trainable`` and ``need_clip`` (a parameter's name is its
module path, so ``name`` stays on the ``ParamAttr``); the layers put the
others on the ``nn.Parameter`` they make, where the optimizer and the
clips read them:

- ``optimize_attr = {'learning_rate': ...}``: the parameter's learning
  rate is the optimizer's times this;
- ``regularizer``: replaces the optimizer's ``weight_decay`` for it;
- ``need_clip``: False exempts its gradient from the clip;
- ``requires_grad = trainable``.

``bias_attr=False`` means no bias, as in the reference. Note that
``copy.deepcopy`` of a ``Parameter`` copies its data and not these
attributes (torch's ``Parameter.__deepcopy__``): ``copy_param_attrs``
carries them from one module to a copy of it.
"""
import math

import numpy as np
import torch

from ..device import resolve_device

__all__ = ['Initializer', 'Constant', 'Uniform', 'Normal', 'TruncatedNormal',
           'XavierUniform', 'XavierNormal', 'KaimingUniform', 'KaimingNormal',
           'Assign', 'Bilinear', 'MSRA', 'Xavier', 'NumpyArrayInitializer',
           'ConstantInitializer', 'UniformInitializer', 'NormalInitializer',
           'TruncatedNormalInitializer', 'XavierInitializer',
           'MSRAInitializer', 'BilinearInitializer', 'ParamAttr',
           'calculate_gain', 'set_global_initializer', 'create_parameter',
           'apply_param_attr', 'copy_param_attrs']

_ATTRS = ('optimize_attr', 'regularizer', 'need_clip')


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels, paddle layout (cout, cin, *k) or NHWC (k, k, cin, cout):
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in = shape[-2] * receptive
    fan_out = shape[-1] * receptive
    return fan_in, fan_out


def calculate_gain(nonlinearity, param=None):
    gains = {'sigmoid': 1.0, 'linear': 1.0, 'conv1d': 1.0, 'conv2d': 1.0,
             'conv3d': 1.0, 'tanh': 5.0 / 3, 'relu': math.sqrt(2.0),
             'leaky_relu': math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             'selu': 3.0 / 4}
    return gains.get(nonlinearity, 1.0)


def _torch_dtype(dtype):
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(np.dtype(dtype)) if str(dtype) != 'bfloat16'
                   else 'bfloat16')


class Initializer:
    def __call__(self, shape, dtype=None, device=None, generator=None):
        """-> a tensor of ``shape`` on ``device`` (by default the
        generator's, else the CUDA device: ``device='cpu'`` for the
        CPU)."""
        shape = tuple(int(s) for s in shape)
        if device is None and generator is not None:
            device = generator.device
        return self.generate(shape, _torch_dtype(dtype),
                             resolve_device(device), generator)

    def generate(self, shape, dtype, device, generator):
        raise NotImplementedError


def _uniform(shape, dtype, device, generator, low, high):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        low, high, generator=generator)


def _normal(shape, dtype, device, generator):
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=generator)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self._value = value

    def generate(self, shape, dtype, device, generator):
        return torch.full(shape, self._value, dtype=dtype, device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high = low, high

    def generate(self, shape, dtype, device, generator):
        return _uniform(shape, dtype, device, generator, self._low,
                        self._high)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, seed=0):
        self._mean, self._std = mean, std

    def generate(self, shape, dtype, device, generator):
        return self._mean + self._std * _normal(shape, dtype, device,
                                                generator)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, seed=0):
        self._mean, self._std = mean, std

    def generate(self, shape, dtype, device, generator):
        x = torch.empty(shape, dtype=dtype, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return self._mean + self._std * x


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, seed=0):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def limit(self, shape):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        return self._gain * math.sqrt(6.0 / (fi + fo))

    def generate(self, shape, dtype, device, generator):
        limit = self.limit(shape)
        return _uniform(shape, dtype, device, generator, -limit, limit)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, seed=0):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def std(self, shape):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        return self._gain * math.sqrt(2.0 / (fi + fo))

    def generate(self, shape, dtype, device, generator):
        return self.std(shape) * _normal(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity='relu',
                 seed=0):
        self._fan_in = fan_in
        self._gain = calculate_gain(nonlinearity, negative_slope)

    def limit(self, shape):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        return self._gain * math.sqrt(3.0 / fi)

    def generate(self, shape, dtype, device, generator):
        limit = self.limit(shape)
        return _uniform(shape, dtype, device, generator, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity='relu',
                 seed=0):
        self._fan_in = fan_in
        self._gain = calculate_gain(nonlinearity, negative_slope)

    def std(self, shape):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        return self._gain / math.sqrt(fi)

    def generate(self, shape, dtype, device, generator):
        return self.std(shape) * _normal(shape, dtype, device, generator)


class Assign(Initializer):
    def __init__(self, value):
        self._value = np.asarray(value)

    def generate(self, shape, dtype, device, generator):
        v = torch.as_tensor(np.array(self._value), device=device).to(dtype)
        if tuple(v.shape) != tuple(shape):
            v = v.reshape(shape)
        return v


class Bilinear(Initializer):
    """For upsampling deconv kernels: (kh, kw, cin, cout) or (cout, cin,
    kh, kw), as the reference lays it out."""

    def generate(self, shape, dtype, device, generator):
        w = np.zeros(shape, dtype=np.float32)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects 4-D weights")
        kh, kw = (shape[0], shape[1]) if shape[0] <= shape[2] \
            else (shape[2], shape[3])
        factor = (kh + 1) // 2
        center = (factor - 1) if kh % 2 == 1 else (factor - 0.5)
        og = np.ogrid[:kh, :kw]
        f = (1 - abs(og[0] - center) / factor) * \
            (1 - abs(og[1] - center) / factor)
        if shape[0] == kh:  # (kh, kw, cin, cout)
            w[:, :, :, :] = f[:, :, None, None]
        else:  # (cout, cin, kh, kw)
            w[:, :, :, :] = f[None, None, :, :]
        return torch.from_numpy(w).to(device=device, dtype=dtype)


# fluid-era aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
Xavier = XavierUniform
XavierInitializer = XavierUniform
MSRA = KaimingNormal
MSRAInitializer = KaimingNormal
BilinearInitializer = Bilinear
NumpyArrayInitializer = Assign

_global_weight_init = [None]
_global_bias_init = [None]


def set_global_initializer(weight_init, bias_init=None):
    _global_weight_init[0] = weight_init
    _global_bias_init[0] = bias_init


def global_weight_initializer():
    return _global_weight_init[0]


def global_bias_initializer():
    return _global_bias_init[0]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """``None`` -> a default ``ParamAttr``, a ``str`` -> one with that
        name, an ``Initializer`` -> one with it, a bool -> a default one
        (True) or False (no parameter), a list -> a list of them."""
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        raise TypeError(f"Invalid param attr: {arg!r}")

    def __repr__(self):
        return (f"ParamAttr(name={self.name!r}, initializer="
                f"{self.initializer!r}, learning_rate={self.learning_rate}, "
                f"regularizer={self.regularizer!r}, trainable="
                f"{self.trainable}, need_clip={self.need_clip})")


def create_parameter(shape, attr=None, *, device, generator=None,
                     is_bias=False, default=None, transpose=False):
    """A layer's parameter of the reference's ``shape`` -> an
    ``nn.Parameter`` with ``attr``'s settings, or None for ``attr=False``.
    Its value: ``attr.initializer``, else ``default`` (the layer's own
    draw: a function filling an empty tensor in place), else the global
    initializer (the bias one for ``is_bias``), else zeros for a bias and
    ``XavierUniform`` for a weight; drawn from ``generator``. With
    ``transpose`` the value is stored transposed (a ``Linear`` weight)."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer
    stored = tuple(reversed(shape)) if transpose else tuple(shape)
    if init is None and default is not None:
        value = torch.empty(stored, device=device)
        with torch.no_grad():
            default(value)
    else:
        if init is None:
            glob = global_bias_initializer() if is_bias \
                else global_weight_initializer()
            init = glob or (Constant(0.0) if is_bias else XavierUniform())
        with torch.no_grad():
            value = init(tuple(shape), device=device, generator=generator)
            if transpose:
                value = value.t()
            value = value.contiguous()
    return apply_param_attr(torch.nn.Parameter(value), attr)


def apply_param_attr(param, attr):
    """Put ``attr``'s settings on ``param`` (an ``nn.Parameter``) ->
    ``param``."""
    attr = ParamAttr._to_attr(attr)
    param.optimize_attr = {'learning_rate': float(attr.learning_rate)}
    param.regularizer = attr.regularizer
    param.need_clip = bool(attr.need_clip)
    param.requires_grad_(bool(attr.trainable))
    return param


def copy_param_attrs(src, dst):
    """Carry the ``ParamAttr`` settings of ``src``'s parameters onto the
    same-named parameters of ``dst`` (a copy of ``src``)."""
    own = dict(dst.named_parameters())
    for name, p in src.named_parameters():
        q = own.get(name)
        if q is None:
            continue
        for a in _ATTRS:
            if hasattr(p, a):
                setattr(q, a, getattr(p, a))
        q.requires_grad_(p.requires_grad)
    return dst
