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

TF32 products of TF32 values are exact in fp32 (11 by 11 significant
bits), so an fp32 matmul of rounded operands is the tensor core's product
up to the order of the fp32 sums. ``cvt.rna.tf32.f32`` rounds to 10
mantissa bits, to nearest, ties away from zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
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


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 2, 77, 40)],
                         ids=["128x64", "77x40"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tf32x3_forward_meets_the_fp32_gate(shape, with_bias, causal):
    # a batch row whose every key is -inf: o = 0 and lse = LSE_EMPTY. Not
    # under the causal mask, where the reference's NEG_INF above the
    # diagonal leaves such a row a softmax over those keys instead
    # (ROADMAP, Queue 3)
    empty_row = with_bias and shape[0] > 1 and not causal
    q, k, v, bias = _inputs(shape, with_bias, empty_row,
                            seed=sum(shape) + 7 * causal)
    scale = 1.0 / np.sqrt(shape[-1])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)

    ro, rlse = tfa._attn_reference(*t, causal, scale, tb)
    o3, lse3 = _attention(*t, causal, scale, tb, _mm_tf32x3)
    assert torch.isfinite(o3).all()
    assert _err(o3, ro) <= TOL and _err(lse3, rlse) <= TOL
    if empty_row:
        assert (o3[1] == 0).all() and (lse3[1] == tfa.LSE_EMPTY).all()

    jo = jfa.flash_attention_bhld(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, kpad_bias=None if bias is None else jnp.asarray(bias),
        interpret=True)
    assert _err(o3, torch.from_numpy(np.array(jo))) <= TOL

    # one TF32 product misses the gate on the same inputs
    o1, lse1 = _attention(*t, causal, scale, tb, _mm_tf32)
    assert max(_err(o1, ro), _err(lse1, rlse)) > TOL


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
