"""The port's dropout-mask generator (``kernels/philox.py``) and the dropout
built on it.

Philox4x32-10 is held to the known-answer vectors published with Random123
(``kat_vectors``). The mask is then checked for what the kernels rely on:
it is a function of (seed, offset, element index) only, so the forward and
the backward of every dropout site see the same bits.

The JAX package's in-kernel PRNG is a zero stub in interpret mode
(``paddle_tpu/kernels/flash_attention.py:20-24``) and on a TPU gives other
bits anyway, so ``p > 0`` is NOT compared element by element across the
packages: the port's dropped attention is compared with ``paddle_tpu``'s
``_attn_reference`` in expectation (the mean over 64 seeds, within 3 sigma
of the undropped output).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_dropout_norm as tfdn
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.kernels.philox import DropoutState
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch import nn as tnn


def _u64(lo, hi):
    return lo | (hi << 32)


def _as_i64(v):
    """A 64-bit pattern as the int64 holding it."""
    return v - (1 << 64) if v >= (1 << 63) else v


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox4x32_10_known_answers(ctr, key, want):
    # counter words 0, 1 are the element group, 2, 3 the call offset
    index4 = torch.tensor([_as_i64(_u64(ctr[0], ctr[1]))], dtype=torch.int64)
    out = philox.philox4x32(_u64(*key), _u64(ctr[2], ctr[3]), index4)
    assert out.shape == (1, 4) and out.dtype == torch.int64
    assert tuple(int(w) for w in out[0]) == want


def test_threshold_is_the_reference_rule():
    assert philox.threshold(0.0) == 0
    assert philox.threshold(0.1) == int(0.1 * 4294967296.0)
    assert philox.threshold(0.5) == 2 ** 31
    assert philox.threshold(1.0) == 2 ** 32 - 1


def test_mask_is_a_function_of_seed_offset_and_element():
    a = philox.keep_mask((7, 33), 0.3, seed=11, offset=5)
    assert a.dtype == torch.bool and a.shape == (7, 33)
    assert torch.equal(a, philox.keep_mask((7, 33), 0.3, 11, 5))
    assert not torch.equal(a, philox.keep_mask((7, 33), 0.3, 11, 6))
    assert not torch.equal(a, philox.keep_mask((7, 33), 0.3, 12, 5))
    # keyed on the linear index: another shape of the same elements, or a
    # longer tensor's head, carries the same bits
    assert torch.equal(a.reshape(-1),
                       philox.keep_mask((231,), 0.3, 11, 5))
    assert torch.equal(a.reshape(-1),
                       philox.keep_mask((1000,), 0.3, 11, 5)[:231])
    # 64-bit seeds and offsets are used whole
    big = philox.keep_mask((64,), 0.5, 2 ** 63 + 5, 2 ** 40)
    assert not torch.equal(big, philox.keep_mask((64,), 0.5, 5, 2 ** 40))
    assert not torch.equal(big, philox.keep_mask((64,), 0.5, 2 ** 63 + 5, 0))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_three_sigma(p):
    n = 400_000
    rate = philox.keep_mask((n,), p, 3, 0).double().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(rate - (1 - p)) < 3 * sigma
    ks = philox.keep_scale((1000,), p, 3, 0)
    kept = ks[ks > 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / (1 - p)))


def test_dropout_state_counts_calls_and_replays():
    st = DropoutState.from_generator(torch.Generator().manual_seed(5))
    again = DropoutState.from_generator(torch.Generator().manual_seed(5))
    other = DropoutState.from_generator(torch.Generator().manual_seed(6))
    assert st.seed == again.seed != other.seed
    assert [st.next() for _ in range(3)] == [(st.seed, 0), (st.seed, 1),
                                             (st.seed, 2)]
    assert st.offset == 3
    with pytest.raises(ValueError, match='torch.Generator'):
        DropoutState.from_generator(None)  # no implicit generator
    x = torch.ones(4, 50)
    a, b = TF.dropout(x, 0.5, True, st), TF.dropout(x, 0.5, True, st)
    assert not torch.equal(a, b)          # successive calls, other masks
    st.offset = 3
    assert torch.equal(TF.dropout(x, 0.5, True, st), a)   # replayed


def test_functional_dropout_semantics():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    st = DropoutState(9)
    assert TF.dropout(x, 0.3, training=False) is x
    assert TF.dropout(x, 0.0, training=True) is x
    assert st.offset == 0                  # nothing dropped, nothing drawn
    y = TF.dropout(x, 0.3, True, st)
    keep = philox.keep_mask(x.shape, 0.3, 9, 0)
    torch.testing.assert_close(y, torch.where(keep, x / 0.7,
                                              torch.zeros_like(x)))
    with pytest.raises(ValueError, match='dropout_state'):
        TF.dropout(x, 0.3, True)           # no implicit generator
    layer = tnn.Dropout(0.3, dropout_state=DropoutState(1))
    assert torch.equal(layer.eval()(x), x)
    assert (layer.train()(x) == 0).float().mean().item() > 0.2
    # a layer that was given no state passes through in eval and raises
    # when training asks it to drop: it never falls back to a seed of its own
    alone = tnn.Dropout(0.3)
    assert alone.eval()(x) is x
    with pytest.raises(ValueError, match='dropout_state'):
        alone.train()(x)
    attn = tnn.MultiHeadAttention(64, 4, dropout=0.3, device='cpu').train()
    with pytest.raises(ValueError, match='dropout_state'):
        attn(x[None])
    enc = tnn.TransformerEncoderLayer(64, 4, 64, dropout=0.3, device='cpu')
    assert torch.isfinite(enc.eval()(x[None])).all()
    with pytest.raises(ValueError, match='dropout_state'):
        enc.train()(x[None])


def test_forward_and_backward_masks_are_equal():
    """Every dropout site rebuilds its forward mask in its backward: the
    gradient is non-zero exactly where the forward kept the element."""
    rs = np.random.RandomState(0)
    seed, offset, p = 77, 4, 0.4
    # add + LayerNorm: d/dx reaches x only through the kept elements
    x = torch.tensor(rs.randn(6, 32), dtype=torch.float64,
                     requires_grad=True)
    res = torch.tensor(rs.randn(6, 32), dtype=torch.float64)
    y = tfdn.fused_dropout_add_layer_norm(x, res, dropout_p=p, seed=seed,
                                          offset=offset)
    (y * torch.tensor(rs.randn(6, 32))).sum().backward()
    keep = philox.keep_mask((6, 32), p, seed, offset)
    assert torch.equal(x.grad != 0, keep)
    g = torch.tensor(rs.randn(6, 32), dtype=torch.float32)
    assert torch.equal(tfdn.dropout_grad(g, p, seed, offset) != 0, keep)
    # attention: with v = I-like probes, dv sees P * keep column by column
    b, h, L = 1, 2, 16
    q, k = (torch.tensor(rs.randn(b, h, L, 8), dtype=torch.float32)
            for _ in range(2))
    v = torch.eye(L).expand(b, h, L, L).contiguous()
    o, lse = tfa.flash_attention_forward(q, k, v, dropout_p=p, seed=seed,
                                         offset=offset)
    keep = philox.keep_mask((b, h, L, L), p, seed, offset)
    assert torch.equal(o != 0, keep)       # o = P * keep / (1 - p)
    do = torch.ones_like(o)
    _, _, dv = tfa.flash_attention_backward(q, k, v, o, lse, do,
                                            dropout_p=p, seed=seed,
                                            offset=offset)
    # dv[key, c] = sum_q (P keep)[q, key] dO[q, c]: zero iff the key's
    # whole column was dropped
    assert torch.equal(dv[..., 0] != 0, keep.any(-2))


def test_dropped_attention_matches_reference_in_expectation():
    rs = np.random.RandomState(1)
    b, h, L, d, p, n_seeds = 1, 2, 32, 8, 0.2, 64
    q, k, v = (rs.randn(b, h, L, d).astype(np.float32) for _ in range(3))
    ref = np.asarray(jfa._attn_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, d ** -0.5))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    outs = torch.stack([tfa.flash_attention_bhld(
        tq, tk, tv, dropout_p=p, seed=1000 + s, offset=s)
        for s in range(n_seeds)]).numpy()
    # each output element is sum_j P_ij keep_ij v_j / (1-p): unbiased, with
    # variance p/(1-p) sum_j P_ij^2 v_j^2 over one draw
    probs = np.asarray(jfa._attn_reference(
        jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(np.eye(L, dtype=np.float32))[None, None].repeat(h, 1),
        False, d ** -0.5))                  # v = I gives P itself
    var = p / (1 - p) * np.einsum('bhlm,bhmd->bhld', probs ** 2, v ** 2)
    sigma = np.sqrt(var / n_seeds)
    z = np.abs(outs.mean(0) - ref) / np.maximum(sigma, 1e-12)
    assert z.max() < 4.5          # 512 elements: 3 sigma each, Bonferroni
    assert (z < 3).mean() > 0.98
    assert np.abs(outs[0] - ref).max() > 1e-3      # it does drop
