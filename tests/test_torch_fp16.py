"""fp16 in the port: the plain versions of the seven kernels against the
JAX package's Pallas kernels at fp16, where the reference rounds, and the
dtype-rounded dropout scale.

On the CPU each port wrapper runs its kernel's plain version; the JAX side
runs the Pallas kernel bodies in interpret mode (``jax.grad`` through
their ``custom_vjp`` for gradients), as the JAX package's own kernel tests
run them and as ``test_torch_bf16.py`` does at bf16. The same numpy
inputs, cast to fp16 on each side (round to nearest even on both), go to
both.

Tolerances. An fp16 output or gradient of a kernel: 2e-3 of its largest
absolute value, a fifth of bf16's 1e-2: fp16 keeps 3 more mantissa bits
(one step is 2^-11 = 4.9e-4 relative), and both sides compute in fp32 and
round at the same points, so they differ by a step or two where sums
taken in another order straddle a rounding boundary or a rounded P or dS
feeds a product. fp32 statistics (``lse``, ``mean``, ``rstd``): 1e-5
relative, the order of summation only. The mask gradient: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import fused_dropout_norm as jfdn
from paddle_tpu.kernels.fused_norm import _ln_forward as jax_ln_forward
from paddle_tpu.kernels.fused_norm import fused_layer_norm as jax_ln
from paddle_tpu.kernels.fused_norm import fused_rms_norm as jax_rms

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_dropout_norm as tfdn
from paddle_tpu_torch.kernels import fused_norm as tfn
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.kernels.philox import DropoutState
from paddle_tpu_torch.nn import functional as TF

H16 = torch.float16
TOL = 2e-3
STAT_TOL = 1e-5


def _rand(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(a).to(H16)


def _j(a):
    return jnp.asarray(a).astype(jnp.float16)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what, tol=TOL):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err)


def _stats_close(got, want, what):
    np.testing.assert_allclose(_np32(got), _np32(want).reshape(
        _np32(got).shape), rtol=STAT_TOL, atol=STAT_TOL, err_msg=what)


def _cos_loss(y):
    yf = y.float()
    return (yf * torch.cos(yf)).sum()


def _jcos_loss(y):
    yf = y.astype(jnp.float32)
    return jnp.sum(yf * jnp.cos(yf))


def test_the_kernels_take_fp16():
    # csrc/dtype.cuh's kF16; an fp16 tensor passes the dtype check and is
    # refused only for its device (meta tensors take the kernel branch)
    assert _build.DTYPES[H16] == 2
    meta = torch.empty(4, 8, device='meta', dtype=H16)
    with pytest.raises(ValueError, match='expected a CUDA tensor'):
        tfn.fused_layer_norm(meta)
    with pytest.raises(ValueError, match='expected a CUDA tensor'):
        tfdn.dropout_grad(meta, 0.1, 1, 0)


# ---------------------------------------------------------------------------
# LayerNorm, RMSNorm, dropout + add + LayerNorm, the mask gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_fp16_matches_pallas(affine):
    x = _rand(0, 48, 256, scale=2.0, shift=0.5)
    w = _rand(1, 256, scale=0.2, shift=1.0) if affine else None
    b = _rand(2, 256) if affine else None
    args = [x] + ([w, b] if affine else [])
    ja = [_j(a) for a in args]
    ry, rmean, rrstd = jax_ln_forward(ja[0], *(ja[1:] if affine
                                               else (None, None)), 1e-5, True)
    ts = [_t(a).requires_grad_() for a in args]
    y, mean, rstd = tfn.layer_norm_stats(ts[0], *(ts[1:] if affine
                                                  else (None, None)), 1e-5)
    assert y.dtype == H16 and mean.dtype == rstd.dtype == torch.float32
    _close(y, ry, 'y')
    _stats_close(mean, rmean, 'mean')
    _stats_close(rstd, rrstd, 'rstd')
    ref = jax.grad(lambda *a: _jcos_loss(jax_ln(
        a[0], *(a[1:] if affine else (None, None)), eps=1e-5,
        interpret=True)), argnums=tuple(range(len(args))))(
            *(_j(a) for a in args))
    out = tfn.fused_layer_norm(ts[0], *(ts[1:] if affine else (None, None)),
                               1e-5)
    assert out.dtype == H16
    _cos_loss(out).backward()
    for t, r, name in zip(ts, ref, ('dx', 'dw', 'db')):
        assert t.grad.dtype == H16
        _close(t.grad, r, name)


@pytest.mark.parametrize("weighted", [True, False])
def test_rms_norm_fp16_matches_pallas(weighted):
    x = _rand(2, 3, 16, 128, scale=1.5)
    w = _rand(3, 128, scale=0.2, shift=1.0) if weighted else None
    args = [x] + ([w] if weighted else [])
    ref_y = jax_rms(_j(x), None if w is None else _j(w), eps=1e-6,
                    interpret=True)
    ref = jax.grad(lambda *a: _jcos_loss(jax_rms(
        a[0], a[1] if weighted else None, eps=1e-6, interpret=True)),
        argnums=tuple(range(len(args))))(*(_j(a) for a in args))
    ts = [_t(a).requires_grad_() for a in args]
    y = tfn.fused_rms_norm(ts[0], ts[1] if weighted else None, 1e-6)
    assert y.dtype == H16
    _close(y, ref_y, 'y')
    _cos_loss(y).backward()
    for t, r, name in zip(ts, ref, ('dx', 'dw')):
        assert t.grad.dtype == H16
        _close(t.grad, r, name)


@pytest.mark.parametrize("affine", [True, False])
def test_add_layer_norm_fp16_matches_pallas(affine):
    # the statistics come from the fp32 sum, y and yin are rounded to fp16,
    # and the backward forms xhat from the rounded yin (_fdln_bwd)
    x, res = _rand(3, 48, 256), _rand(4, 48, 256, scale=2.0)
    w = _rand(5, 256, scale=0.2, shift=1.0) if affine else None
    b = _rand(6, 256) if affine else None
    args = [x, res] + ([w, b] if affine else [])
    wb = lambda a: a[2:] if affine else (None, None)   # noqa: E731
    outs = jfdn._fused_fwd(*(_j(a) for a in args[:2]),
                           *(_j(a) if a is not None else None
                             for a in wb(args)),
                           jnp.zeros((1, 1), jnp.int32), 1e-5, 0.0, True)
    ts = [_t(a).requires_grad_() for a in args]
    got = tfdn._plain_stats(ts[0], ts[1], *wb(ts), 0.0, 1e-5, None, None)
    for g_, r_, name in zip(got, outs, ('y', 'yin', 'mean', 'rstd')):
        if name in ('y', 'yin'):
            assert g_.dtype == H16
            _close(g_, r_, name)
        else:
            assert g_.dtype == torch.float32
            _stats_close(g_, r_, name)
    total = ts[1].detach().float() + ts[0].detach().float()
    assert torch.equal(got[1], total.to(H16))
    ref = jax.grad(lambda *a: _jcos_loss(jfdn.fused_dropout_add_layer_norm(
        a[0], a[1], *(a[2:] if affine else (None, None)), dropout_p=0.0,
        interpret=True)), argnums=tuple(range(len(args))))(
            *(_j(a) for a in args))
    y = tfdn.fused_dropout_add_layer_norm(ts[0], ts[1], *wb(ts))
    _cos_loss(y).backward()
    for t, r, name in zip(ts, ref, ('dx', 'dres', 'dw', 'db')):
        assert t.grad.dtype == H16
        _close(t.grad, r, name)


def test_dropout_mask_gradient_fp16_is_the_reference_arithmetic():
    # the reference's _dmask_kernel: g.astype(f32) * keep / (1 - p) in
    # fp32, cast to fp16; with the port's Philox mask the two agree bit for
    # bit, and the mask is the fp32 and bf16 kernels' mask
    p, seed, offset = 0.1, 0x1234567890ABCDEF, 5
    g = _rand(7, 64, 256, scale=3.0)
    keep = philox.keep_mask(g.shape, p, seed, offset).numpy()
    want = (jnp.asarray(g).astype(jnp.float16).astype(jnp.float32)
            * (keep.astype(np.float32) / (1.0 - p))).astype(jnp.float16)
    got = tfdn.dropout_grad(_t(g), p, seed, offset)
    assert got.dtype == H16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    ones = tfdn.dropout_grad(torch.ones(1001, dtype=H16), p, seed, offset)
    assert torch.equal(ones != 0, philox.keep_mask((1001,), p, seed, offset))


def test_add_layer_norm_fp16_dropout_keeps_the_fp32_mask():
    x = torch.ones(32, 128, dtype=H16)
    y32 = tfdn.fused_dropout_add_layer_norm(x.float(), torch.zeros(32, 128),
                                            dropout_p=0.5, seed=3, offset=1)
    y16 = tfdn.fused_dropout_add_layer_norm(x, torch.zeros_like(x),
                                            dropout_p=0.5, seed=3, offset=1)
    assert y16.dtype == H16
    assert torch.equal(y16 > 0, y32 > 0)
    assert torch.equal(y16 > 0, philox.keep_mask((32, 128), 0.5, 3, 1))


def test_functional_dropout_fp16_divides_by_the_fp16_keep_rate():
    # the reference's where(keep, v / (1 - p), 0): the weakly typed 1 - p
    # takes v's dtype (0.9 -> 0.89990234375), the quotient rounds once
    x = _rand(8, 16, 64, scale=2.0)
    y = TF.dropout(_t(x), 0.1, True, DropoutState(11))
    keep = philox.keep_mask(x.shape, 0.1, 11, 0).numpy()
    want = np.where(keep, np.asarray((_j(x) / (1.0 - 0.1)).astype(
        jnp.float32)), 0.0).astype(np.float16)
    assert y.dtype == H16
    np.testing.assert_array_equal(y.numpy().view(np.int16),
                                  want.view(np.int16))
    # the fp32 scale 1/0.9 would round other quotients
    other = torch.where(torch.from_numpy(keep), _t(x) * (1.0 / 0.9), 0.0)
    assert not torch.equal(y, other)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

B, H, L, D = 2, 3, 128, 16
BQ = BK = 64


def _qkv(seed):
    return [_rand(seed + i, B, H, L, D) for i in range(3)]


def _kpad(seed):
    lengths = np.random.RandomState(seed).randint(L // 2, L + 1, size=B)
    bias = np.zeros((B, L), np.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = -1e4         # exact in fp16 (bf16 holds -9984)
    return bias


@pytest.mark.parametrize("causal,with_bias", [(False, False), (True, False),
                                              (False, True)])
def test_flash_forward_fp16_matches_pallas(causal, with_bias):
    q, k, v = _qkv(20)
    bias = _kpad(23) if with_bias else None
    ro, rlse = jfa._flash_forward(
        _j(q), _j(k), _j(v), None if bias is None else jnp.asarray(bias),
        jnp.zeros((1, 1), jnp.int32), causal, 1.0 / np.sqrt(D), BQ, BK, 0.0,
        True)
    o, lse = tfa.flash_attention_forward(
        _t(q), _t(k), _t(v), causal=causal,
        kpad_bias=None if bias is None else torch.from_numpy(bias))
    assert o.dtype == H16 and lse.dtype == torch.float32 and ro.dtype == \
        jnp.float16
    _close(o, ro, 'o')
    _stats_close(lse, rlse, 'lse')


@pytest.mark.parametrize("causal,with_bias", [(False, False), (True, False),
                                              (False, True)])
def test_flash_backward_fp16_matches_pallas(causal, with_bias):
    q, k, v = _qkv(70)
    bias = _kpad(73) if with_bias else None
    ref = jax.grad(lambda q_, k_, v_: _jcos_loss(jfa.flash_attention_bhld(
        q_, k_, v_, causal=causal,
        kpad_bias=None if bias is None else jnp.asarray(bias),
        block_q=BQ, block_k=BK, interpret=True)), argnums=(0, 1, 2))(
            _j(q), _j(k), _j(v))
    tb = None if bias is None else torch.from_numpy(bias)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    o = tfa.flash_attention_bhld(*ts, causal=causal, kpad_bias=tb)
    _cos_loss(o).backward()
    for t, r, name in zip(ts, ref, 'qkv'):
        assert t.grad.dtype == H16
        _close(t.grad, r, f'd{name}')
    # the plain dQ and dK/dV, called as the kernels are: fp16 q/k/v/dO,
    # fp32 lse and delta
    with torch.no_grad():
        tq, tk, tv = (t.detach() for t in ts)
        o2, lse = tfa.flash_attention_forward(tq, tk, tv, causal=causal,
                                              kpad_bias=tb)
        of = o2.float()
        do = (torch.cos(of) - of * torch.sin(of)).to(H16)
        delta = (do.float() * of).sum(-1)
        rest = (lse, delta, causal, 1.0 / np.sqrt(D), tb)
        dq = tfa.flash_attention_dq(tq, tk, tv, do, *rest)
        dk, dv = tfa.flash_attention_dkv(tq, tk, tv, do, *rest)
    for got, r, name in zip((dq, dk, dv), ref, 'qkv'):
        assert got.dtype == H16
        _close(got, r, f'plain d{name}')


def test_flash_plain_versions_round_at_fp16_and_overflow_as_the_cast():
    # P and dS enter their products as fp16 values; a dS past 65504 (a
    # scaled loss's gradient) is inf there, as the reference's cast makes
    # it, and the gradients that take it are not finite
    q, k, v = (_t(a) for a in _qkv(40))
    o, lse = tfa._attn_reference(q, k, v, False, 0.25)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = qf @ kf.transpose(-1, -2) * 0.25
    p = torch.exp(s - s.amax(-1, keepdim=True))
    assert torch.equal(o, ((p.to(H16).float() @ vf)
                           / p.sum(-1, keepdim=True)).to(H16))
    do = _t(_rand(44, B, H, L, D))
    delta = (do.float() * o.float()).sum(-1)
    _, ds = tfa._p_ds(q, k, v, do, lse, delta, False, 0.25, None, 0.1, 5, 6)
    assert torch.equal(ds, ds.to(H16).float()) and torch.isfinite(ds).all()
    # uniform P (q = 0) over values of +-100 by key, and dO of 6e4: dP is
    # +-1e8, delta ~ 0, so dS = P (dP - delta) ~ 7.5e5 > 65504
    q = torch.zeros_like(q)
    v = (100.0 * torch.tensor([1.0, -1.0]).repeat(L // 2)[:, None]
         .expand(B, H, L, D)).to(H16)
    big = torch.full_like(q, 6e4)
    o, lse = tfa._attn_reference(q, k, v, False, 0.25)
    delta = (big.float() * o.float()).sum(-1)
    _, ds = tfa._p_ds(q, k, v, big, lse, delta, False, 0.25, None, 0.0,
                      None, None)
    assert torch.isinf(ds).any()
    dq = tfa.flash_attention_dq(q, k, v, big, lse, delta, False, 0.25)
    assert not torch.isfinite(dq).all()
    # so do the reference's Pallas kernels on the same inputs
    jq, jk, jv, jo, jdo = (_j(_np32(t)) for t in (q, k, v, o, big))
    rdq = jfa._flash_backward(jq, jk, jv, jo, jnp.asarray(_np32(lse)), None,
                              jnp.zeros((1, 1), jnp.int32), jdo, False, 0.25,
                              BQ, BK, 0.0, True)[0]
    assert not np.isfinite(_np32(rdq)).all()
