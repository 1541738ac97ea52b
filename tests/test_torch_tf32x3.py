"""The fp32 attention forward's 3xTF32 arithmetic against the fp32 gate.

On the card the fp32 flash-attention forward (``flash_fwd_tf32_kernel`` in
``paddle_tpu_torch/kernels/csrc/flash_attention.cu``) runs both of its
products, Q K^T and P V, on the tensor cores as 3xTF32: each fp32 operand
is split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, and ``a b`` is
``a_lo b_hi + a_hi b_lo + a_hi b_hi``, three TF32 products with fp32
accumulation. ``chip_smoke.py`` holds that kernel to ``TOL`` (1e-4 max abs
on o and lse) against ``_attn_reference``. This file shows on the CPU,
before any card runs it, that the arithmetic itself meets that gate: the
same split, emulated in torch, gives an attention forward within ``TOL`` of
the port's plain version and of the JAX package's ``flash_attention_bhld``
(Pallas in interpret mode); while one TF32 product per product, on the same
inputs, does not, which is why the split is there.

The fp32 dQ and dK/dV kernels (``flash_dq_tf32_kernel``,
``flash_dkv_tf32_kernel`` in ``csrc/flash_attention_bwd.cu``) take all five
of their products the same way (S = Q K^T, dP = dO V^T, dS K, P^T dO and
dS^T Q); ``chip_smoke.py`` holds them to ``GRAD_TOL`` (1e-3 of each
gradient's max). The emulated backward is held here to that gate against
the port's ``_dq_reference`` / ``_dkv_reference`` and against ``jax.grad``
through the Pallas kernels in interpret mode.

Every attention kernel takes its scores in natural units, rounded as the
reference rounds them: ``dot * scale``, then ``+ bias``. The last test
shows why on a causal row whose keys all carry BERT's bf16 key bias
(-9984): the log2-domain scores the bf16 kernels used to take,
``fmaf(dot, scale * log2(e), bias * log2(e))``, put lse past the 1e-4 gate
on fp32 statistics; natural units keep it.

TF32 products of TF32 values are exact in fp32 (11 by 11 significant
bits), so an fp32 matmul of rounded operands is the tensor core's product
up to the order of the fp32 sums. ``cvt.rna.tf32.f32`` rounds to 10
mantissa bits, to nearest, ties away from zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRAD_TOL, STAT_TOL, TOL
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa


def _tf32(x):
    """``cvt.rna.tf32.f32`` on every element: fp32 bit patterns with the
    low 13 mantissa bits rounded away (half an ulp added to the magnitude,
    which is sign-and-magnitude, then truncated)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32x3(a, b):
    """``a @ b`` as the kernel computes it: lo hi + hi lo + hi hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a, b):
    """``a @ b`` with one TF32 product: what plain TF32 would give."""
    return _tf32(a) @ _tf32(b)


def _attention(q, k, v, causal, scale, bias, mm):
    """``_attn_reference``'s forward with both products through ``mm`` ->
    ``(o, lse)``: scores scaled after the product, as the kernel scales
    them; -inf above the diagonal; o = 0 and lse = LSE_EMPTY for a row
    without a finite score."""
    s = mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float('-inf'))
    m = s.amax(-1, keepdim=True).clamp_min(tfa.NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    denom = l.clamp_min(1e-30)
    o = mm(p, v) / denom
    lse = torch.where(l > 0, m + torch.log(denom),
                      torch.full_like(l, tfa.LSE_EMPTY))
    return o, lse.squeeze(-1)


def _inputs(shape, with_bias, empty_row, seed):
    """q, k, v ~ N(0, 1) and, with ``with_bias``, BERT's -1e4 key padding
    at random lengths; with ``empty_row``, batch row 1's every key -inf."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    bias = None
    if with_bias:
        b, _, L, _ = shape
        bias = np.where(np.arange(L)[None, :] <
                        rs.randint(L // 4, L + 1, size=(b, 1)),
                        0.0, -1e4).astype(np.float32)
        if empty_row:
            bias[1] = -np.inf
    return q, k, v, bias


def _backward(q, k, v, do, o, lse, causal, scale, bias, mm):
    """The backward kernels' arithmetic with all five products through
    ``mm`` -> ``(dq, dk, dv)``: P rebuilt from the forward's ``lse`` on
    scores scaled after the product, ``delta = rowsum(dO * O)``, dQ and dK
    scaled once at the end."""
    s = mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float('-inf'))
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), do))


def _case(shape, with_bias, causal):
    """The inputs of one case: q, k, v, the bias and dO as numpy arrays,
    and whether batch row 1 is the -inf row. That row is not made under
    the causal mask, where the reference's NEG_INF above the diagonal
    leaves such a row a softmax over those keys instead (ROADMAP, Queue
    3)."""
    empty_row = with_bias and shape[0] > 1 and not causal
    seed = sum(shape) + 7 * causal
    q, k, v, bias = _inputs(shape, with_bias, empty_row, seed)
    do = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    return q, k, v, bias, do, empty_row


@pytest.fixture(scope='module')
def jax_side():
    """The JAX package's ``flash_attention_bhld`` through the Pallas kernels
    in interpret mode -> ``run(shape, with_bias, causal)``: ``(o, dq, dk,
    dv)`` as torch tensors, ``jax.vjp`` with dO under one ``jax.jit``,
    computed once per case for the module's tests."""
    cache = {}

    def run(shape, with_bias, causal):
        key = (shape, with_bias, causal)
        if key not in cache:
            q, k, v, bias, do, _ = _case(shape, with_bias, causal)
            jb = None if bias is None else jnp.asarray(bias)

            def attention(q_, k_, v_):
                return jfa.flash_attention_bhld(
                    q_, k_, v_, causal=causal, scale=1.0 / np.sqrt(shape[-1]),
                    kpad_bias=jb, interpret=True)

            @jax.jit
            def forward_and_grads(q_, k_, v_, do_):
                o, vjp = jax.vjp(attention, q_, k_, v_)
                return (o, *vjp(do_))
            out = forward_and_grads(*(jnp.asarray(a) for a in (q, k, v, do)))
            cache[key] = tuple(torch.from_numpy(np.array(a)) for a in out)
        return cache[key]
    return run


def _err(a, b):
    return float((a - b).abs().max())


def _rel(a, b):
    """Max abs error over ``b``'s max abs value, as chip_smoke.rel_err."""
    return _err(a, b) / max(float(b.abs().max()), 1e-30)


SHAPES = pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 2, 77, 40)],
                                 ids=["128x64", "77x40"])
BIAS = pytest.mark.parametrize("with_bias", [False, True],
                               ids=["nobias", "bias"])
CAUSAL = pytest.mark.parametrize("causal", [False, True],
                                 ids=["full", "causal"])


@SHAPES
@BIAS
@CAUSAL
def test_tf32x3_forward_meets_the_fp32_gate(shape, with_bias, causal,
                                            jax_side):
    q, k, v, bias, _, empty_row = _case(shape, with_bias, causal)
    scale = 1.0 / np.sqrt(shape[-1])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)

    ro, rlse = tfa._attn_reference(*t, causal, scale, tb)
    o3, lse3 = _attention(*t, causal, scale, tb, _mm_tf32x3)
    assert torch.isfinite(o3).all()
    assert _err(o3, ro) <= TOL and _err(lse3, rlse) <= TOL
    if empty_row:
        assert (o3[1] == 0).all() and (lse3[1] == tfa.LSE_EMPTY).all()

    assert _err(o3, jax_side(shape, with_bias, causal)[0]) <= TOL

    # one TF32 product misses the gate on the same inputs
    o1, lse1 = _attention(*t, causal, scale, tb, _mm_tf32)
    assert max(_err(o1, ro), _err(lse1, rlse)) > TOL


@SHAPES
@BIAS
@CAUSAL
def test_tf32x3_backward_meets_the_fp32_gate(shape, with_bias, causal,
                                             jax_side):
    q, k, v, bias, do, empty_row = _case(shape, with_bias, causal)
    scale = 1.0 / np.sqrt(shape[-1])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tdo = torch.from_numpy(do)
    tb = None if bias is None else torch.from_numpy(bias)

    # each side from its own forward, as the kernels start from theirs
    o3, lse3 = _attention(*t, causal, scale, tb, _mm_tf32x3)
    grads3 = _backward(*t, tdo, o3, lse3, causal, scale, tb, _mm_tf32x3)
    ro, rlse = tfa._attn_reference(*t, causal, scale, tb)
    rest = (rlse, (tdo * ro).sum(-1), causal, scale, tb)
    plain = (tfa._dq_reference(*t, tdo, *rest),
             *tfa._dkv_reference(*t, tdo, *rest))
    for g3, rg, jg in zip(grads3, plain, jax_side(shape, with_bias,
                                                  causal)[1:]):
        assert torch.isfinite(g3).all()
        assert _rel(g3, rg) <= GRAD_TOL and _rel(g3, jg) <= GRAD_TOL
        if empty_row:          # no key of batch row 1 weighs anything
            assert (g3[1] == 0).all()


def test_natural_units_keep_lse_next_to_a_large_bias():
    """A causal attention whose first 96 keys carry BERT's bf16 key bias
    (-9984), so that query rows 0-95 have no key without it. There a
    score's ulp is 2^-10. The kernels' natural-unit scores (two fp32
    roundings, dot * scale then + bias; the softmax in natural units) give
    lse within STAT_TOL of the JAX package's Pallas forward on those rows;
    the log2-domain scores the bf16 kernels took before
    (fmaf(dot, scale * log2(e), bias * log2(e)), lse = m ln(2) + log(l),
    each fmaf emulated in float64 and rounded once to fp32) do not."""
    b, h, L, d = 1, 4, 128, 64
    rs = np.random.RandomState(11)
    q, k = (rs.randn(b, h, L, d).astype(np.float32) for _ in range(2))
    bias = np.zeros((b, L), np.float32)
    bias[:, :96] = -9984.0
    scale = np.float32(1.0 / np.sqrt(d))
    dot = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2)
    masked = ~torch.ones(L, L, dtype=torch.bool).tril()
    tb = torch.from_numpy(bias)[:, None, None, :]

    s = (dot * float(scale) + tb).masked_fill(masked, float('-inf'))
    m = s.amax(-1, keepdim=True)
    natural = (m + torch.log(torch.exp(s - m).sum(-1, keepdim=True)))[..., 0]

    log2e, ln2 = np.float32(np.log2(np.e)), np.float32(np.log(2.0))
    scale2 = torch.tensor(scale * log2e, dtype=torch.float32)
    b2 = tb * torch.tensor(log2e)          # bias * log2(e), rounded to fp32
    s2 = (dot.double() * scale2.double() + b2.double()).float()
    s2 = s2.masked_fill(masked, float('-inf'))
    m2 = s2.amax(-1, keepdim=True)
    l2 = torch.exp2(s2 - m2).sum(-1, keepdim=True)
    log2 = (m2.double() * float(ln2) + torch.log(l2).double()).float()[..., 0]

    _, jlse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.zeros_like(jnp.asarray(q)),
        jnp.asarray(bias), None, True, float(scale), L, L, 0.0, True)
    jlse = torch.from_numpy(np.array(jlse))
    rows = slice(0, 96)
    assert _err(natural[..., rows], jlse[..., rows]) <= STAT_TOL
    assert _err(log2[..., rows], jlse[..., rows]) > STAT_TOL
    # the port's plain version rounds as the kernels now do
    _, rlse = tfa._attn_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(q), True, float(scale),
                                  torch.from_numpy(bias))
    assert _err(natural, rlse) <= STAT_TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10                     # a TF32 ulp at 1.0
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp * 1.5,
                      1.0 + ulp / 2 - 2.0 ** -23, 3.0, float('-inf')])
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0 + 2 * ulp, 1.0, 3.0,
                         float('-inf')])
    assert torch.equal(_tf32(x), want)
    # the split: hi + lo carries x to within 2^-22 of its magnitude
    y = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert ((hi + lo - y).abs() <= 2.0 ** -22 * y.abs()).all()
    assert ((hi - y).abs() <= 2.0 ** -11 * y.abs()).all()
