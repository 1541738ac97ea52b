"""Attention functionals. Counterpart of
``paddle_tpu/nn/functional/transformer.py``
(``scaled_dot_product_attention``, ``_mask_as_kpad_bias``,
``multi_head_attention``).

Inputs are paddle-layout (B, L, H, D). With no mask, or a mask that
reduces to a (B, Lk) key-padding bias — BERT's (B, 1, 1, L) padding mask —
and Lq == Lk, attention goes to ``kernels.flash_attention`` (the CUDA
kernel on CUDA tensors, its plain version on CPU tensors). Other masks
take the composed path, as in the reference. In training with
``dropout_p > 0`` the call draws its ``(seed, offset)`` from
``dropout_state``, as the reference draws a seed per call from its key
chain; both paths drop with the same Philox mask. The reference's
``_FLASH_MIN_SEQ`` threshold and autotune lookup are TPU measurements and
are not carried over.
"""
import math

import torch

from ...kernels.flash_attention import MAX_HEAD_DIM, flash_attention_bhld
from ...kernels.philox import head_block, keep_scale
from .common import linear, next_dropout_call

__all__ = ['scaled_dot_product_attention', 'multi_head_attention']


def _mask_as_kpad_bias(m, batch, lk):
    """Convert a (B|1, 1, 1, Lk) boolean/additive mask to the (B, Lk)
    fp32 additive bias the flash kernel streams (an additive mask keeps the
    values of its dtype, as the reference's kernel reads
    ``bias.astype(float32)``); None for any other shape."""
    if m.dim() != 4 or m.shape[1] != 1 or m.shape[2] != 1:
        return None
    if m.shape[3] != lk or m.shape[0] not in (1, batch):
        return None
    bias = m.reshape(m.shape[0], lk)
    if bias.dtype == torch.bool:
        bias = torch.where(bias, 0.0, -1e9)
    bias = bias.to(torch.float32)
    if bias.shape[0] == 1:
        bias = bias.expand(batch, lk)
    return bias


def _composed(q, k, v, mask, dropout_p, is_causal, seed, offset,
              head_map=None):
    """Plain attention on (B, H, L, D) for masks the kernel does not take."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, -1e30)
        else:
            scores = scores + mask
    if is_causal:
        keep = torch.ones(scores.shape[-2:], dtype=torch.bool,
                          device=scores.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0:
        probs = probs * keep_scale(probs.shape, dropout_p, seed, offset,
                                   probs.device, probs.dtype,
                                   head_block(probs.shape, head_map))
    return torch.matmul(probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, dropout_state=None,
                                 head_map=None):
    """query/key/value: (B, L, H, D). Returns (B, L, H, D).
    ``head_map=(heads, h0)``: the H heads are heads ``h0 ..`` of a model
    of ``heads`` heads, whose dropout masks they draw
    (``kernels.flash_attention.mask_args``)."""
    p_eff = float(dropout_p) if training else 0.0
    seed, offset = next_dropout_call(dropout_state, p_eff,
                                     'scaled_dot_product_attention')
    # (B, L, H, D) -> (B, H, L, D) views; the kernel reads these strides
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    kpad = None
    flashable = (query.shape[1] == key.shape[1]
                 and query.shape[-1] <= MAX_HEAD_DIM)
    if flashable and attn_mask is not None:
        kpad = _mask_as_kpad_bias(attn_mask, query.shape[0], key.shape[1])
        flashable = kpad is not None
    if flashable:
        out = flash_attention_bhld(q, k, v, causal=is_causal,
                                   kpad_bias=kpad, dropout_p=p_eff,
                                   seed=seed, offset=offset,
                                   head_map=head_map)
    else:
        out = _composed(q, k, v, attn_mask, p_eff, is_causal, seed, offset,
                        head_map)
    return out.transpose(1, 2)


def multi_head_attention(query, key, value, num_heads, wq, wk, wv, wo,
                         bq=None, bk=None, bv=None, bo=None, attn_mask=None,
                         dropout_p=0.0, is_causal=False, cache=None,
                         training=True, dropout_state=None):
    """Functional attention on (B, L, E) inputs with the projection
    weights in ``linear``'s layout, (out, in) (the reference's are (in,
    out)). ``cache``: any object with ``append_k(k)`` / ``append_v(v)``
    returning the keys and values to attend over, (B, T, H, D), as the
    reference calls them."""
    q, k, v = linear(query, wq, bq), linear(key, wk, bk), \
        linear(value, wv, bv)
    B, Lq, E = q.shape
    hd = E // num_heads
    q = q.reshape(B, Lq, num_heads, hd)
    k = k.reshape(B, k.shape[1], num_heads, hd)
    v = v.reshape(B, v.shape[1], num_heads, hd)
    if cache is not None:
        k = cache.append_k(k)
        v = cache.append_v(v)
    out = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                       dropout_p=dropout_p,
                                       is_causal=is_causal,
                                       training=training,
                                       dropout_state=dropout_state)
    return linear(out.reshape(B, Lq, E), wo, bo)
