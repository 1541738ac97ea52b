"""RMSNorm of the port (``kernels.fused_norm.fused_rms_norm``,
``nn.functional.rms_norm``, ``nn.RMSNorm``) against the JAX package.

On the CPU the port runs the kernel's plain version (``rms_norm_stats``
forward, the closed-form ``rms_norm_backward``); the JAX side runs the
Pallas kernel ``_rms_fwd_kernel`` in interpret mode and its ``custom_vjp``
backward through ``jax.grad``. The same numpy inputs go to both.

Tolerances. fp32: 2e-5 absolute and relative (row sums over 128-256 terms
in another order; observed at most 7.2e-7 on outputs and 1.1e-5 absolute,
1.1e-6 of the largest value, on gradients). bf16: 1e-2 of the largest
absolute value of the output or gradient — both sides compute in fp32 and
round once to bf16, so they differ by at most one bf16 step (2^-8
relative) where the fp32 values fall on either side of a rounding boundary
(observed: 5.2e-3 of the max on outputs; the gradients came out
identical). ``nn.RMSNorm`` is held to the reference's
layer, whose CPU path divides by ``sqrt`` where the kernel multiplies by
``rsqrt`` (fp32, 2e-5).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.kernels.fused_norm import fused_rms_norm as jax_rms
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.nn import functional as TF

TOL32 = 2e-5
TOL16 = 1e-2

DTYPES = {'fp32': (torch.float32, jnp.float32),
          'bf16': (torch.bfloat16, jnp.bfloat16)}


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift
            ).astype(np.float32)


def _to_torch(a, dtype):
    """numpy fp32 -> torch ``dtype`` (bf16 rounds to nearest even, as
    JAX's cast does)."""
    return torch.from_numpy(a).to(dtype)


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dt, what):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, what
    if dt == 'fp32':
        np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= TOL16 * np.abs(want).max(), (what, err)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("weighted", [True, False])
def test_rms_norm_forward_matches_pallas(dt, weighted):
    tdt, jdt = DTYPES[dt]
    x = _rand(0, 48, 256, scale=2.0, shift=0.3)
    w = _rand(1, 256, scale=0.2, shift=1.0) if weighted else None
    ref = jax_rms(_to_jax(x, jdt), None if w is None else _to_jax(w, jdt),
                  eps=1e-6, interpret=True)
    out = tfn.fused_rms_norm(_to_torch(x, tdt),
                             None if w is None else _to_torch(w, tdt), 1e-6)
    assert out.dtype == tdt and ref.dtype == jdt
    _close(out, ref, dt, 'y')
    # the statistics stay fp32 whatever the input dtype
    y, rstd = tfn.rms_norm_stats(_to_torch(x, tdt), None, 1e-6)
    assert rstd.dtype == torch.float32 and rstd.shape == (48,)
    xf = _to_torch(x, tdt).float()
    torch.testing.assert_close(
        rstd, torch.rsqrt((xf * xf).mean(-1) + 1e-6), rtol=1e-5, atol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("weighted", [True, False])
def test_rms_norm_backward_matches_pallas(dt, weighted):
    tdt, jdt = DTYPES[dt]
    x = _rand(2, 3, 16, 128, scale=1.5)
    w = _rand(3, 128, scale=0.2, shift=1.0) if weighted else None
    args = [x] + ([w] if weighted else [])

    def ref_loss(*a):
        y = jax_rms(a[0], a[1] if weighted else None, eps=1e-6,
                    interpret=True)
        yf = y.astype(jnp.float32)
        return jnp.sum(yf * jnp.cos(yf))
    ref = jax.grad(ref_loss, argnums=tuple(range(len(args))))(
        *(_to_jax(a, jdt) for a in args))
    ts = [_to_torch(a, tdt).requires_grad_() for a in args]
    y = tfn.fused_rms_norm(ts[0], ts[1] if weighted else None, 1e-6)
    assert 'RMSNorm' in type(y.grad_fn).__name__
    yf = y.float()
    (yf * torch.cos(yf)).sum().backward()
    for t, r, name in zip(ts, ref, ('dx', 'dw')):
        assert t.grad.dtype == tdt
        _close(t.grad, r, dt, name)


def test_rms_norm_function_gradcheck():
    def f64(seed, *shape):
        return torch.tensor(np.random.RandomState(seed).randn(*shape),
                            dtype=torch.float64, requires_grad=True)
    x, w = f64(4, 2, 3, 10), f64(5, 10)
    assert torch.autograd.gradcheck(
        lambda *a: tfn.fused_rms_norm(*a, 1e-6), (x, w))
    assert torch.autograd.gradcheck(
        lambda a: tfn.fused_rms_norm(a, None, 1e-6), (x,))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_functional_rms_norm_matches_reference(dt):
    tdt, jdt = DTYPES[dt]
    x = _rand(6, 2, 5, 64, scale=3.0)
    w = _rand(7, 64, shift=1.0)
    ref = JF.rms_norm(paddle.to_tensor(_to_jax(x, jdt)),
                      paddle.to_tensor(_to_jax(w, jdt)), 1e-6)
    out = TF.rms_norm(_to_torch(x, tdt), _to_torch(w, tdt), 1e-6)
    assert out.dtype == tdt
    _close(out, ref._value, dt, 'F.rms_norm')


@pytest.mark.parametrize("weight_attr", [None, False])
def test_rms_norm_layer_matches_reference(weight_attr):
    paddle.seed(3)
    ref = jnn.RMSNorm(96, epsilon=1e-5, weight_attr=weight_attr)
    port = tnn.RMSNorm(96, epsilon=1e-5, weight_attr=weight_attr,
                       device='cpu')
    if weight_attr is None:
        # the reference's Constant(1.0); a trained weight moves it
        np.testing.assert_array_equal(np.asarray(ref.weight._value),
                                      port.weight.detach().numpy())
        w = _rand(8, 96, scale=0.3, shift=1.0)
        ref.weight._value = jnp.asarray(w)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(w))
        assert [n for n, _ in port.named_parameters()] == ['weight']
    else:
        assert ref.weight is None and port.weight is None
        assert list(port.parameters()) == []
    x = _rand(9, 4, 7, 96, scale=2.0)
    want = np.asarray(ref(paddle.to_tensor(x))._value)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL32,
                               atol=TOL32)
    if weight_attr is None:
        got.sum().backward()
        assert port.weight.grad is not None and \
            port.weight.grad.shape == (96,)
    assert 'hidden_size=96' in repr(port)
    # a ParamAttr with an initializer, as in the reference; what is not a
    # parameter attribute raises the reference's TypeError
    from paddle_tpu.nn.initializer import Constant as JaxConstant
    from paddle_tpu.nn.initializer import ParamAttr as JaxParamAttr
    from paddle_tpu_torch.nn.initializer import Constant, ParamAttr
    ref2 = jnn.RMSNorm(8, weight_attr=JaxParamAttr(
        initializer=JaxConstant(2.0), learning_rate=0.5))
    port2 = tnn.RMSNorm(8, weight_attr=ParamAttr(
        initializer=Constant(2.0), learning_rate=0.5), device='cpu')
    np.testing.assert_array_equal(port2.weight.detach().numpy(),
                                  np.asarray(ref2.weight._value))
    assert port2.weight.optimize_attr == {'learning_rate': 0.5}
    for make in (jnn.RMSNorm, functools.partial(tnn.RMSNorm, device='cpu')):
        with pytest.raises(TypeError, match='param attr'):
            make(8, weight_attr=object())


def test_rms_norm_bf16_rounds_like_jax():
    # both sides widen to fp32, normalise, round once: the bf16 bits agree
    # except where the two fp32 values straddle a rounding boundary
    x = _rand(10, 64, 512, scale=4.0)
    ref = np.asarray(jax_rms(_to_jax(x, jnp.bfloat16), None, eps=1e-6,
                             interpret=True)).astype(ml_dtypes.bfloat16)
    out = tfn.fused_rms_norm(_to_torch(x, torch.bfloat16), None, 1e-6)
    bits = out.view(torch.int16).numpy()
    ref_bits = ref.view(np.int16)
    assert (bits != ref_bits).mean() < 0.01
    assert np.abs(bits.astype(np.int32) - ref_bits.astype(np.int32)).max() \
        <= 1


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device='meta', dtype=dtype)


@pytest.mark.parametrize("call,match", [
    (lambda: tfn.fused_rms_norm(_meta(4, 8)), 'expected a CUDA tensor'),
    # id "fp16" from before the kernels took float16; float64 they refuse
    (lambda: tfn.fused_rms_norm(_meta(4, 8, dtype=torch.float64)),
     'float32, bfloat16 or float16, got torch.float64'),
    (lambda: tfn.fused_rms_norm(_meta(4, 8, dtype=torch.bfloat16),
                                _meta(8)),
     'weight: dtype torch.float32, expected torch.bfloat16'),
], ids=["cpu-only", "fp16", "mixed"])
def test_rms_norm_kernel_path_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()
    assert 'rms_norm_fwd' in _build.KERNELS
