"""``paddle_tpu_torch.nn.initializer`` against
``paddle_tpu.nn.initializer``: ``Constant``, ``Assign`` and ``Bilinear``
equal the reference's arrays exactly; ``_fans``, ``calculate_gain`` and
every initializer's limit or std are the reference's formulas on the
reference's fans; the random initializers stay in their bounds, their
moments over n >= 10^5 draws are within the stated tolerance of the
analytic ones (as the reference's own draws are), and a generator repeats
them. ``ParamAttr(initializer=)`` on ``Linear`` (the initializer sees the
reference's (in, out) layout), ``Embedding``, ``LayerNorm``,
``RMSNorm`` and the transformer layers, and ``set_global_initializer``
(the bias initializer of a layer without a default), each against the
reference's layer."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import initializer as J

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as T

N = 400 * 512          # 204800 draws


def _ref(init, shape):
    paddle.seed(0)
    return np.asarray(init(shape))


def test_constant_assign_and_bilinear_equal_the_reference():
    def port(init, shape, **kw):
        return init(shape, device='cpu', **kw)
    for shape in [(3,), (4, 5), (2, 3, 4)]:
        np.testing.assert_array_equal(port(T.Constant(0.25), shape).numpy(),
                                      _ref(J.Constant(0.25), shape))
    value = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    for v in (value, value.ravel()):
        np.testing.assert_array_equal(port(T.Assign(v), (3, 4)).numpy(),
                                      _ref(J.Assign(v), (3, 4)))
    for shape in [(4, 4, 2, 3), (3, 2, 4, 4), (3, 3, 5, 2), (2, 5, 3, 3)]:
        np.testing.assert_array_equal(port(T.Bilinear(), shape).numpy(),
                                      _ref(J.Bilinear(), shape))
    # like every entry point, an initializer runs on the card unless told
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            T.Constant(0.25)((3,))
    with pytest.raises(ValueError, match='4-D'):
        port(T.Bilinear(), (3, 3))
    assert port(T.Constant(2.0), (2,), dtype='bfloat16').dtype == \
        torch.bfloat16
    assert port(T.Constant(2.0), (2,), dtype=torch.float16).dtype == \
        torch.float16


SHAPES = [(), (7,), (64, 32), (32, 64), (3, 3, 8, 16), (16, 8, 3, 3),
          (2, 3, 4, 5, 6)]


def test_fans_and_gains_are_the_references():
    for shape in SHAPES:
        assert T._fans(shape) == J._fans(shape), shape
    for name in ['sigmoid', 'linear', 'conv1d', 'conv2d', 'conv3d', 'tanh',
                 'relu', 'leaky_relu', 'selu', 'unknown']:
        for param in (None, 0.2):
            assert T.calculate_gain(name, param) == \
                J.calculate_gain(name, param), (name, param)


LIMITS = {
    'XavierUniform': (lambda s, fi=None, fo=None, g=1.0: g * math.sqrt(
        6.0 / ((fi or J._fans(s)[0]) + (fo or J._fans(s)[1])))),
    'XavierNormal': (lambda s, fi=None, fo=None, g=1.0: g * math.sqrt(
        2.0 / ((fi or J._fans(s)[0]) + (fo or J._fans(s)[1])))),
    'KaimingUniform': (lambda s, fi=None, nl='relu', a=0.0: J.calculate_gain(
        nl, a) * math.sqrt(3.0 / (fi or J._fans(s)[0]))),
    'KaimingNormal': (lambda s, fi=None, nl='relu', a=0.0: J.calculate_gain(
        nl, a) / math.sqrt(fi or J._fans(s)[0])),
}


@pytest.mark.parametrize("name", list(LIMITS))
def test_every_limit_and_std_is_the_references(name):
    formula = LIMITS[name]
    cls = getattr(T, name)
    bound = 'limit' if 'Uniform' in name else 'std'
    for shape in SHAPES[1:]:
        if name.startswith('Xavier'):
            cases = [({}, {}), (dict(fan_in=10, fan_out=30, gain=2.0),
                                dict(fi=10, fo=30, g=2.0))]
        else:
            cases = [({}, {}), (dict(fan_in=12, nonlinearity='leaky_relu',
                                     negative_slope=0.3),
                                dict(fi=12, nl='leaky_relu', a=0.3)),
                     (dict(nonlinearity='tanh'), dict(nl='tanh'))]
        for kw, fkw in cases:
            got = getattr(cls(**kw), bound)(shape)
            assert got == pytest.approx(formula(shape, **fkw), rel=1e-15)


def _moments(x):
    x = np.asarray(x, np.float64).ravel()
    return x.mean(), x.std(), np.abs(x).max()


UNIFORMS = [('Uniform', dict(low=-0.3, high=0.5)), ('XavierUniform', {}),
            ('KaimingUniform', {})]
NORMALS = [('Normal', dict(mean=0.2, std=0.7)), ('XavierNormal', {}),
           ('KaimingNormal', {}), ('TruncatedNormal', dict(mean=-0.1,
                                                           std=0.5))]
# std of N(0, 1) cut at +-2
TRUNC_STD = 0.8796256610


def _expected(name, kw, shape):
    """(low, high) bounds or None, mean, std."""
    if name == 'Uniform':
        lo, hi = kw['low'], kw['high']
        return (lo, hi), (lo + hi) / 2, (hi - lo) / math.sqrt(12)
    if name in ('XavierUniform', 'KaimingUniform'):
        lim = getattr(T, name)().limit(shape)
        return (-lim, lim), 0.0, lim / math.sqrt(3)
    if name == 'Normal':
        return None, kw['mean'], kw['std']
    if name == 'TruncatedNormal':
        m, s = kw['mean'], kw['std']
        return (m - 2 * s, m + 2 * s), m, s * TRUNC_STD
    return None, 0.0, getattr(T, name)().std(shape)


@pytest.mark.parametrize("name,kw", UNIFORMS + NORMALS,
                         ids=[n for n, _ in UNIFORMS + NORMALS])
def test_random_initializers_bounds_moments_and_repeats(name, kw):
    """Moments over 204800 draws: the mean within 5 standard errors, the
    std within 1 %; the reference's draws meet the same bounds."""
    shape = (400, 512)
    bounds, mean, std = _expected(name, kw, shape)
    g = torch.Generator().manual_seed(5)
    x = getattr(T, name)(**kw)(shape, generator=g)
    assert x.shape == shape and x.dtype == torch.float32
    ref = _ref(getattr(J, name)(**kw), shape)
    for draws in (x.numpy(), ref):
        m, s, _ = _moments(draws)
        assert abs(m - mean) <= 5 * std / math.sqrt(N), (m, mean)
        assert abs(s / std - 1) <= 0.01, (s, std)
        if bounds is not None:
            assert draws.min() >= bounds[0] - 1e-6 and \
                draws.max() <= bounds[1] + 1e-6
    again = getattr(T, name)(**kw)(shape, generator=torch.Generator()
                                   .manual_seed(5))
    other = getattr(T, name)(**kw)(shape, generator=torch.Generator()
                                   .manual_seed(6))
    assert torch.equal(x, again) and not torch.equal(x, other)


def test_fluid_aliases():
    assert T.Xavier is T.XavierUniform and T.MSRA is T.KaimingNormal
    assert T.NumpyArrayInitializer is T.Assign
    assert T.ConstantInitializer is T.Constant
    assert T.TruncatedNormalInitializer is T.TruncatedNormal


def test_param_attr_initializer_on_every_layer():
    w = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    # Linear: the initializer sees the reference's (in, out) layout
    ref = jnn.Linear(6, 4, J.ParamAttr(initializer=J.Assign(w)),
                     J.Constant(0.5))
    lin = tnn.Linear(6, 4, T.ParamAttr(initializer=T.Assign(w),
                                       learning_rate=0.5), T.Constant(0.5),
                     device='cpu')
    np.testing.assert_array_equal(lin.weight.detach().numpy().T,
                                  np.asarray(ref.weight._value))
    np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                  np.asarray(ref.bias._value))
    assert lin.weight.optimize_attr == {'learning_rate': 0.5}
    # Kaiming's fan-in is the input width, as in the reference
    g = torch.Generator().manual_seed(1)
    big = tnn.Linear(256, 512, T.KaimingNormal(), device='cpu', generator=g)
    assert float(big.weight.detach().std()) == pytest.approx(
        math.sqrt(2.0 / 256), rel=0.01)
    emb = tnn.Embedding(10, 4, weight_attr=T.ParamAttr(
        initializer=T.Constant(0.1)), device='cpu')
    ref_emb = jnn.Embedding(10, 4, weight_attr=J.ParamAttr(
        initializer=J.Constant(0.1)))
    np.testing.assert_array_equal(emb.weight.detach().numpy(),
                                  np.asarray(ref_emb.weight._value))
    ln = tnn.LayerNorm(4, weight_attr=T.Constant(2.0),
                       bias_attr=T.ParamAttr(initializer=T.Constant(-1.0)),
                       device='cpu')
    ref_ln = jnn.LayerNorm(4, weight_attr=J.Constant(2.0),
                           bias_attr=J.ParamAttr(initializer=J.Constant(-1.0)))
    for a, b in ((ln.weight, ref_ln.weight), (ln.bias, ref_ln.bias)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b._value))
    rms = tnn.RMSNorm(4, weight_attr=T.ParamAttr(
        initializer=T.Uniform(0.5, 0.6)), device='cpu',
        generator=torch.Generator().manual_seed(0))
    w_rms = rms.weight.detach()
    assert 0.5 <= float(w_rms.min()) and float(w_rms.max()) <= 0.6
    mha = tnn.MultiHeadAttention(8, 2, weight_attr=T.Constant(0.25),
                                 bias_attr=T.Constant(0.125), device='cpu')
    for proj in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj):
        assert torch.all(proj.weight == 0.25) and torch.all(proj.bias ==
                                                             0.125)
    layer = tnn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, weight_attr=T.ParamAttr(
            initializer=T.Constant(0.5), learning_rate=0.1),
        bias_attr=False, device='cpu')
    assert torch.all(layer.linear1.weight == 0.5)
    assert layer.linear1.bias is None
    assert layer.linear2.weight.optimize_attr == {'learning_rate': 0.1}
    ref_layer = jnn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, weight_attr=J.ParamAttr(
            initializer=J.Constant(0.5)), bias_attr=False)
    assert np.all(np.asarray(ref_layer.linear1.weight._value) == 0.5)
    assert ref_layer.linear1.bias is None


def test_set_global_initializer_as_the_reference():
    """The reference applies the global initializers only where a layer
    has no default of its own: biases (and weights without one); its
    ``Linear`` and ``LayerNorm`` weights keep their defaults."""
    T.set_global_initializer(T.Constant(0.3), T.Constant(0.7))
    J.set_global_initializer(J.Constant(0.3), J.Constant(0.7))
    try:
        lin = tnn.Linear(4, 3, device='cpu')
        ref = jnn.Linear(4, 3)
        np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                      np.asarray(ref.bias._value))
        assert torch.all(lin.bias == 0.7) and not torch.all(lin.weight == 0.3)
        assert not np.all(np.asarray(ref.weight._value) == 0.3)
        ln = tnn.LayerNorm(4, device='cpu')
        ref_ln = jnn.LayerNorm(4)
        np.testing.assert_array_equal(ln.bias.detach().numpy(),
                                      np.asarray(ref_ln.bias._value))
        np.testing.assert_array_equal(ln.weight.detach().numpy(),
                                      np.asarray(ref_ln.weight._value))
        # an explicit initializer still wins
        assert torch.all(tnn.Linear(4, 3, bias_attr=T.Constant(0.0),
                                    device='cpu').bias == 0.0)
    finally:
        T.set_global_initializer(None, None)
        J.set_global_initializer(None, None)
    assert torch.all(tnn.Linear(4, 3, device='cpu').bias == 0.0)
