"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel bodies in interpret mode, as the JAX
package's own kernel tests do. The same numpy inputs go to both.

Tolerances are fp32: the two sides sum rows and dot products in different
orders, which moves results by a few ulps of values of order 1-10, so
outputs agree to 2e-5 absolute/relative; the logsumexp (values up to
~10) to 5e-5.

The backward is held to ``jax.grad`` through the interpret-mode Pallas
kernels at ``p = 0`` (same tolerance: the closed forms are the
reference's), and each ``torch.autograd.Function`` — plain forward, plain
``_dq_reference``/``_dkv_reference`` or closed-form LayerNorm backward —
to ``torch.autograd.gradcheck`` in float64 with a fixed Philox mask at
``p = 0.1``. Dropout across the packages is compared in
``test_torch_philox.py``, in expectation only.

The CUDA kernels themselves run only on the GPU, where ``chip_smoke.py``
holds each against its plain version; here the wrappers' refusals (no
dropout without a seed, no non-CUDA tensors on the kernel path) are checked
with ``meta`` tensors, which take the kernel branch without a device.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels.fused_dropout_norm import \
    fused_dropout_add_layer_norm as jax_add_ln
from paddle_tpu.kernels.fused_norm import fused_layer_norm as jax_ln
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_dropout_norm as tfdn
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.nn import functional as TF

RTOL = ATOL = 2e-5
LSE_TOL = 5e-5


def _np(x):
    return np.asarray(x)


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# LayerNorm (kernels/fused_norm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [(48, 256), (3, 16, 128), (13, 64)],
                         ids=["2d", "3d", "rows-not-multiple-of-8"])
def test_layer_norm_matches_pallas(affine, shape):
    x = _rand(0, *shape, scale=2.0, shift=0.5)
    d = shape[-1]
    w = _rand(1, d, scale=0.2, shift=1.0) if affine else None
    b = _rand(2, d) if affine else None
    ref = jax_ln(jnp.asarray(x), None if w is None else jnp.asarray(w),
                 None if b is None else jnp.asarray(b), eps=1e-5,
                 interpret=True)
    out = tfn.fused_layer_norm(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), 1e-5)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalized_shape", [(32,), (4, 8)])
def test_functional_layer_norm_matches_reference(normalized_shape):
    x = _rand(3, 2, 5, *normalized_shape, scale=3.0)
    w = _rand(4, *normalized_shape, shift=1.0)
    b = _rand(5, *normalized_shape)
    ref = JF.layer_norm(paddle.to_tensor(x), list(normalized_shape),
                        paddle.to_tensor(w), paddle.to_tensor(b), 1e-5)
    out = TF.layer_norm(torch.from_numpy(x), normalized_shape,
                        torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(out.numpy(), _np(ref._value), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# add + LayerNorm (kernels/fused_dropout_norm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_add_layer_norm_matches_pallas(affine):
    x, res = _rand(6, 48, 256), _rand(7, 48, 256, scale=2.0)
    w = _rand(8, 256, scale=0.2, shift=1.0) if affine else None
    b = _rand(9, 256) if affine else None
    ref = jax_add_ln(jnp.asarray(x), jnp.asarray(res),
                     None if w is None else jnp.asarray(w),
                     None if b is None else jnp.asarray(b), dropout_p=0.0,
                     interpret=True)
    out = tfdn.fused_dropout_add_layer_norm(
        torch.from_numpy(x), torch.from_numpy(res),
        None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), dropout_p=0.0)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_functional_add_layer_norm_eval_matches_reference():
    x, res = _rand(10, 2, 7, 64), _rand(11, 2, 7, 64)
    w, b = _rand(12, 64, shift=1.0), _rand(13, 64)
    ref = JF.fused_dropout_add_layer_norm(
        paddle.to_tensor(x), paddle.to_tensor(res), paddle.to_tensor(w),
        paddle.to_tensor(b), dropout_p=0.1, epsilon=1e-5, training=False)
    out = TF.fused_dropout_add_layer_norm(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(w),
        torch.from_numpy(b), dropout_p=0.1, epsilon=1e-5, training=False)
    np.testing.assert_allclose(out.numpy(), _np(ref._value), rtol=RTOL,
                               atol=ATOL)


def test_plain_add_layer_norm_dropout_keeps_scaled_or_zero():
    # residual 0 and x = 1: after dropout the pre-norm sum is 0 or
    # 1/(1-p), so after LayerNorm the kept elements are the positive ones,
    # and they are the Philox mask of (seed, offset)
    from paddle_tpu_torch.kernels import philox
    x = torch.ones(64, 128)
    y = tfdn.fused_dropout_add_layer_norm(x, torch.zeros_like(x),
                                          dropout_p=0.5, seed=3, offset=1)
    kept = y > 0
    assert 0.3 < kept.float().mean().item() < 0.7
    assert torch.isfinite(y).all()
    assert torch.equal(kept, philox.keep_mask((64, 128), 0.5, 3, 1))
    again = tfdn.fused_dropout_add_layer_norm(x, torch.zeros_like(x),
                                              dropout_p=0.5, seed=3, offset=1)
    assert torch.equal(y, again)


def _cos_loss(y):
    return (y * torch.cos(y)).sum()       # a non-trivial cotangent


@pytest.mark.parametrize("affine", [True, False])
def test_add_layer_norm_backward_matches_pallas(affine):
    x, res = _rand(14, 16, 128), _rand(15, 16, 128, scale=2.0)
    w = _rand(16, 128, scale=0.2, shift=1.0) if affine else None
    b = _rand(17, 128) if affine else None
    args = [x, res] + ([w, b] if affine else [])

    def ref_loss(*a):
        y = jax_add_ln(a[0], a[1], *(a[2:] if affine else (None, None)),
                       dropout_p=0.0, interpret=True)
        return jnp.sum(y * jnp.cos(y))
    ref = jax.grad(ref_loss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = tfdn.fused_dropout_add_layer_norm(
        ts[0], ts[1], *(ts[2:] if affine else (None, None)))
    assert y.grad_fn is not None and 'DropoutAddLayerNorm' in \
        type(y.grad_fn).__name__
    _cos_loss(y).backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_backward_matches_pallas(affine):
    x = _rand(18, 24, 128, scale=2.0, shift=0.5)
    w = _rand(19, 128, scale=0.2, shift=1.0) if affine else None
    b = _rand(20, 128) if affine else None
    args = [x] + ([w, b] if affine else [])

    def ref_loss(*a):
        y = jax_ln(a[0], *(a[1:] if affine else (None, None)), eps=1e-5,
                   interpret=True)
        return jnp.sum(y * jnp.cos(y))
    ref = jax.grad(ref_loss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = tfn.fused_layer_norm(ts[0], *(ts[1:] if affine else (None, None)))
    assert 'LayerNorm' in type(y.grad_fn).__name__
    _cos_loss(y).backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), rtol=RTOL,
                                   atol=ATOL)


def _f64(seed, *shape):
    return torch.tensor(np.random.RandomState(seed).randn(*shape),
                        dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_add_layer_norm_function_gradcheck(p):
    x, res, w, b = _f64(1, 5, 12), _f64(2, 5, 12), _f64(3, 12), _f64(4, 12)
    assert torch.autograd.gradcheck(
        lambda *a: tfdn.fused_dropout_add_layer_norm(
            *a, dropout_p=p, epsilon=1e-5, seed=21, offset=2),
        (x, res, w, b))
    assert torch.autograd.gradcheck(
        lambda a: tfdn.fused_dropout_add_layer_norm(
            a, res.detach(), dropout_p=p, seed=21, offset=2), (x,))


def test_layer_norm_function_gradcheck():
    x, w, b = _f64(5, 2, 3, 10), _f64(6, 10), _f64(7, 10)
    assert torch.autograd.gradcheck(
        lambda *a: tfn.fused_layer_norm(*a, 1e-5), (x, w, b))
    assert torch.autograd.gradcheck(
        lambda a: tfn.fused_layer_norm(a, None, None, 1e-5), (x,))


def test_no_grad_and_eval_forwards_save_nothing():
    x, res = torch.from_numpy(_rand(21, 4, 16)), \
        torch.from_numpy(_rand(22, 4, 16))
    y = tfdn.fused_dropout_add_layer_norm(x, res)
    assert y.grad_fn is None
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        assert tfdn.fused_dropout_add_layer_norm(xg, res).grad_fn is None
        assert tfn.fused_layer_norm(xg).grad_fn is None
    assert tfdn._forward(x, res, None, None, 0.0, 1e-5, None, None,
                         False)[1:] == (None, None, None)


# ---------------------------------------------------------------------------
# flash attention (kernels/flash_attention.py)
# ---------------------------------------------------------------------------

B, H, L, D = 2, 3, 128, 16
BQ = BK = 64


def _qkv(seed):
    return (_rand(seed, B, H, L, D), _rand(seed + 1, B, H, L, D),
            _rand(seed + 2, B, H, L, D))


def _kpad(seed, value=-1e9):
    lengths = np.random.RandomState(seed).randint(L // 2, L + 1, size=B)
    bias = np.zeros((B, L), np.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = value
    return bias


def _pallas_forward(q, k, v, bias, causal):
    return jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias),
        jnp.zeros((1, 1), jnp.int32), causal, 1.0 / np.sqrt(D), BQ, BK,
        0.0, True)


def _port_forward(q, k, v, bias, causal):
    t = torch.from_numpy
    return tfa.flash_attention_forward(
        t(q), t(k), t(v), causal=causal,
        kpad_bias=None if bias is None else t(bias))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_forward_o_and_lse_match_pallas(causal, with_bias):
    q, k, v = _qkv(20)
    bias = _kpad(23) if with_bias else None
    ro, rlse = _pallas_forward(q, k, v, bias, causal)
    o, lse = _port_forward(q, k, v, bias, causal)
    assert o.shape == (B, H, L, D) and lse.shape == (B, H, L)
    np.testing.assert_allclose(o.numpy(), _np(ro), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _np(rlse), rtol=LSE_TOL,
                               atol=LSE_TOL)
    bhld = tfa.flash_attention_bhld(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        kpad_bias=None if bias is None else torch.from_numpy(bias))
    assert torch.equal(bhld, o)


@pytest.mark.parametrize("value", [-1e9, -np.inf], ids=["-1e9", "-inf"])
def test_flash_fully_masked_rows_match_pallas(value):
    # batch row 1 masks every key: a large finite bias leaves a uniform
    # softmax over the masked keys; -inf leaves no key, so o = 0 and
    # lse = LSE_EMPTY on both sides (never NaN)
    q, k, v = _qkv(30)
    bias = _kpad(33)
    bias[1, :] = value
    ro, rlse = _pallas_forward(q, k, v, bias, False)
    o, lse = _port_forward(q, k, v, bias, False)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), _np(ro), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _np(rlse), rtol=LSE_TOL,
                               atol=LSE_TOL)
    if value == -np.inf:
        assert (o[1] == 0).all() and (lse[1] == tfa.LSE_EMPTY).all()


def _torch_qkv(q, k, v):
    return [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_backward_matches_pallas(causal, with_bias):
    q, k, v = _qkv(70)
    bias = _kpad(73) if with_bias else None

    def ref_loss(q, k, v):
        o = jfa.flash_attention_bhld(
            q, k, v, causal=causal,
            kpad_bias=None if bias is None else jnp.asarray(bias),
            block_q=BQ, block_k=BK, interpret=True)
        return jnp.sum(o * jnp.cos(o))
    ref = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tb = None if bias is None else torch.from_numpy(bias)
    ts = _torch_qkv(q, k, v)
    o = tfa.flash_attention_bhld(*ts, causal=causal, kpad_bias=tb)
    assert 'paddle_tpu_torch_flash_attention' in type(o.grad_fn).__name__
    _cos_loss(o).backward()
    for t, r, name in zip(ts, ref, 'qkv'):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), rtol=RTOL,
                                   atol=ATOL, err_msg=f'd{name}')
    # the plain dQ and dK/dV versions, called as the kernels are: from the
    # saved (o, lse) and the output gradient
    with torch.no_grad():
        tq, tk, tv = (t.detach() for t in ts)
        o2, lse = tfa.flash_attention_forward(tq, tk, tv, causal=causal,
                                              kpad_bias=tb)
        do = torch.cos(o2) - o2 * torch.sin(o2)
        delta = (do * o2).sum(-1)
        scale = 1.0 / np.sqrt(D)
        dq = tfa._dq_reference(tq, tk, tv, do, lse, delta, causal, scale, tb)
        dk, dv = tfa._dkv_reference(tq, tk, tv, do, lse, delta, causal,
                                    scale, tb)
    for got, r in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), _np(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("value", [-1e9, -np.inf], ids=["-1e9", "-inf"])
def test_flash_fully_masked_rows_zero_grads(value):
    # every key of every batch row masked: finite gradients, never NaN;
    # with -inf the row has no key at all, so o and every gradient are 0
    q, k, v = _qkv(80)
    bias = torch.full((B, L), value)
    ts = _torch_qkv(q, k, v)
    o = tfa.flash_attention_bhld(*ts, kpad_bias=bias)
    (o ** 2).sum().backward()
    for t in ts:
        assert torch.isfinite(t.grad).all()
    if value == -np.inf:
        assert (o == 0).all()
        assert all((t.grad == 0).all() for t in ts)
    else:
        ref = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention_bhld(
            q, k, v, kpad_bias=jnp.asarray(bias.numpy()), block_q=BQ,
            block_k=BK, interpret=True) ** 2), argnums=(0, 1, 2))(
                *(jnp.asarray(a) for a in (q, k, v)))
        for t, r in zip(ts, ref):
            np.testing.assert_allclose(t.grad.numpy(), _np(r), rtol=RTOL,
                                       atol=ATOL)


def test_flash_causal_row_with_no_allowed_key_is_empty():
    # causal and a batch row whose keys are all -inf: every query row is
    # empty (o = 0, lse = LSE_EMPTY), whatever lies above the diagonal
    q, k, v = (torch.from_numpy(a) for a in _qkv(85))
    bias = torch.zeros(B, L)
    bias[1] = float('-inf')
    o, lse = tfa.flash_attention_forward(q, k, v, causal=True, kpad_bias=bias)
    assert (o[1] == 0).all() and (lse[1] == tfa.LSE_EMPTY).all()
    assert torch.isfinite(o).all() and (lse[0] < 1e3).all()


@pytest.mark.parametrize("causal,with_bias,p", [
    (False, False, 0.1), (True, False, 0.1), (False, True, 0.1),
    (True, True, 0.0)])
def test_flash_function_gradcheck(causal, with_bias, p):
    b, h, L_, d = 1, 2, 6, 4
    q, k, v = _f64(90, b, h, L_, d), _f64(91, b, h, L_, d), \
        _f64(92, b, h, L_, d)
    bias = None
    if with_bias:
        bias = torch.tensor([[0.0, -1e4, 0.0, 0.0, -np.inf, 0.0]],
                            dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: tfa.flash_attention_bhld(
            *a, causal=causal, kpad_bias=bias, dropout_p=p, seed=31,
            offset=4), (q, k, v))


def test_flash_backward_with_dropout_matches_autograd_of_plain():
    # p = 0.1: dQ, dK, dV of the Function (P rebuilt from lse, the mask
    # regenerated) against autograd through the written-out attention with
    # the same mask
    from paddle_tpu_torch.kernels import philox
    q, k, v = _qkv(95)
    bias = torch.from_numpy(_kpad(98, value=-1e4))
    ts = _torch_qkv(q, k, v)
    o = tfa.flash_attention_bhld(*ts, kpad_bias=bias, dropout_p=0.1,
                                 seed=8, offset=3)
    _cos_loss(o).backward()
    rs_ = _torch_qkv(q, k, v)
    s = rs_[0] @ rs_[1].transpose(-1, -2) / np.sqrt(D) + \
        bias[:, None, None, :]
    probs = torch.softmax(s, -1) * philox.keep_scale(s.shape, 0.1, 8, 3)
    ro = probs @ rs_[2]
    np.testing.assert_allclose(o.detach().numpy(), ro.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    _cos_loss(ro).backward()
    for t, r in zip(ts, rs_):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_ragged_length_matches_reference(causal):
    # L = 100 does not tile into the Pallas blocks; the port's kernel has
    # no such rule, and its plain version agrees with the JAX reference
    rs = np.random.RandomState(40)
    q, k, v = (rs.randn(2, 2, 100, 24).astype(np.float32) for _ in range(3))
    bias = np.where(rs.rand(2, 100) < 0.3, -1e4, 0.0).astype(np.float32)
    ref = jfa._attn_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, 0.3, jnp.asarray(bias))
    o, _ = tfa._attn_reference(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, 0.3,
                               torch.from_numpy(bias))
    np.testing.assert_allclose(o.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# scaled_dot_product_attention dispatch (nn/functional/transformer.py)
# ---------------------------------------------------------------------------

def _mask(kind, b, h, lq, seed):
    rs = np.random.RandomState(seed)
    if kind == 'kpad-additive':
        return np.where(rs.rand(b, 1, 1, lq) < 0.3, -1e4, 0.0).astype(
            np.float32)
    if kind == 'kpad-bool':
        m = rs.rand(b, 1, 1, lq) > 0.3
        m[..., 0] = True
        return m
    if kind == 'kpad-broadcast':
        return np.where(rs.rand(1, 1, 1, lq) < 0.3, -1e4, 0.0).astype(
            np.float32)
    if kind == 'dense':
        return rs.randn(b, h, lq, lq).astype(np.float32)
    return None


@pytest.mark.parametrize("kind,causal", [
    ('none', False), ('none', True), ('kpad-additive', False),
    ('kpad-bool', False), ('kpad-broadcast', False), ('dense', False)])
def test_sdpa_matches_reference(kind, causal, monkeypatch):
    b, lq, h, d = 2, 24, 4, 8
    q, k, v = (_rand(50 + i, b, lq, h, d) for i in range(3))
    mask = _mask(kind, b, h, lq, 60)
    calls = []
    monkeypatch.setattr(
        TF.transformer, 'flash_attention_bhld',
        lambda *a, **kw: calls.append(1) or tfa.flash_attention_bhld(*a, **kw))
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=None if mask is None else paddle.to_tensor(mask),
        is_causal=causal, training=False)
    out = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal, training=False)
    assert out.shape == (b, lq, h, d)
    np.testing.assert_allclose(out.numpy(), _np(ref._value), rtol=RTOL,
                               atol=ATOL)
    # key-padding masks and no mask take the flash path; others compose
    assert bool(calls) == (kind != 'dense')


# ---------------------------------------------------------------------------
# CUDA-path refusals, checked without a GPU
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(*shape, device='meta')


@pytest.mark.parametrize("call", [
    lambda **kw: tfdn.fused_dropout_add_layer_norm(
        _meta(4, 8), _meta(4, 8), dropout_p=0.1, **kw),
    lambda **kw: tfa.flash_attention_bhld(
        _meta(1, 2, 8, 4), _meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
        dropout_p=0.1, **kw),
    lambda **kw: tfa.flash_attention_forward(
        _meta(1, 2, 8, 4), _meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
        dropout_p=0.1, **kw),
], ids=["add-ln", "flash-bhld", "flash-forward"])
def test_cuda_wrappers_refuse_dropout(call):
    # dropout without the call's Philox seed and offset is refused on every
    # device (no implicit generator); with them the kernel path is taken,
    # which a meta tensor cannot enter
    with pytest.raises(ValueError, match='Philox seed'):
        call()
    with pytest.raises(ValueError, match='Philox seed'):
        call(seed=1)
    with pytest.raises(ValueError, match='expected a CUDA tensor'):
        call(seed=1, offset=0)


@pytest.mark.parametrize("call", [
    lambda: tfn.fused_layer_norm(_meta(4, 8)),
    lambda: tfdn.fused_dropout_add_layer_norm(_meta(4, 8), _meta(4, 8)),
    lambda: tfa.flash_attention_bhld(_meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
                                     _meta(1, 2, 8, 4)),
    lambda: tfdn.dropout_grad(_meta(4, 8), 0.1, 1, 0),
    lambda: tfa.flash_attention_backward(
        *(_meta(1, 2, 8, 4),) * 4, _meta(1, 2, 8), _meta(1, 2, 8, 4)),
], ids=["ln", "add-ln", "flash", "dropout-grad", "flash-backward"])
def test_kernel_path_refuses_non_cuda_tensors(call):
    with pytest.raises(ValueError, match='expected a CUDA tensor'):
        call()


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text import BertConfig, BertModel
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertModel(BertConfig(vocab_size=10, hidden_size=8,
                             num_hidden_layers=1, num_attention_heads=2,
                             intermediate_size=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')
    assert ServingEngine(device='cpu').device == torch.device('cpu')


# ---------------------------------------------------------------------------
# the kernel build (kernels/_build.py), driven by a stand-in nvcc
# ---------------------------------------------------------------------------

_FAKE_NVCC = '''#!{python}
import os, sys
args = sys.argv[1:]
with open(os.environ['FAKE_NVCC_LOG'], 'a') as f:
    f.write(' '.join(args) + '\\n')
broken = os.environ.get('FAKE_NVCC_FAIL')
if broken and '-c' in args and args[args.index('-c') + 1].endswith(broken):
    print('error: stand-in compile failure')
    sys.exit(1)
with open(args[args.index('-o') + 1], 'w') as f:
    f.write('object')
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    import shutil
    import sys
    from paddle_tpu_torch.kernels import _build
    nvcc = tmp_path / 'cuda' / 'bin' / 'nvcc'
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, csrc)
    log = tmp_path / 'nvcc.log'
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'cuda'))
    monkeypatch.setenv('FAKE_NVCC_LOG', str(log))
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    return _build, csrc, log


def test_build_compiles_each_source_for_sm90a_then_reuses(fake_nvcc):
    _build, csrc, log = fake_nvcc
    lib = _build.build()
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert _build._digest() in lib.name
    calls = log.read_text().splitlines()
    compiled = sorted(c.split(' -c ')[1].split()[0].rsplit('/', 1)[1]
                      for c in calls if ' -c ' in c)
    assert compiled == sorted(p.name for p in csrc.glob('*.cu'))
    assert sum('-shared' in c for c in calls) == 1
    assert all('arch=compute_90a,code=sm_90a' in c for c in calls)
    assert (lib.parent / (lib.name + '.log')).exists()
    # unchanged sources: the library is reused, nothing is compiled
    assert _build.build() == lib
    assert len(log.read_text().splitlines()) == len(calls)
    # an edited source gets a library of its own
    flash = csrc / 'flash_attention.cu'
    flash.write_text(flash.read_text() + '\n// edited\n')
    assert _build.build() != lib


def test_build_failure_raises_with_the_compiler_output(fake_nvcc,
                                                       monkeypatch):
    _build, _, _ = fake_nvcc
    monkeypatch.setenv('FAKE_NVCC_FAIL', 'fused_norm.cu')
    with pytest.raises(RuntimeError, match=r'fused_norm\.cu.*\n(.|\n)*'
                                           r'stand-in compile failure'):
        _build.build()
    assert not list(_build.BUILD_DIR.glob('*.so'))


def test_plain_versions_context_sends_any_device_to_the_plain_path():
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    x = _meta(4, 8)
    assert _build.use_kernels(x) and not _build.use_kernels(torch.ones(2))
    with kernels.plain_versions():
        assert not _build.use_kernels(x)
        with kernels.plain_versions():
            assert not _build.use_kernels(x)
        assert not _build.use_kernels(x)
    assert _build.use_kernels(x)
    assert set(kernels.launch_counts()) == set(kernels.KERNELS) == {
        'flash_attention_fwd', 'flash_attention_dq', 'flash_attention_dkv',
        'layer_norm_fwd', 'rms_norm_fwd', 'add_layer_norm_fwd',
        'dropout_grad'}
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())
