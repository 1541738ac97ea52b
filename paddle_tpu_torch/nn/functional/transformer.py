"""Attention functionals. Counterpart of
``paddle_tpu/nn/functional/transformer.py``
(``scaled_dot_product_attention``, ``_mask_as_kpad_bias``).

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
from ...kernels.philox import keep_scale
from .common import next_dropout_call

__all__ = ['scaled_dot_product_attention']


def _mask_as_kpad_bias(m, batch, lk):
    """Convert a (B|1, 1, 1, Lk) boolean/additive mask to the (B, Lk)
    additive bias the flash kernel streams; None for any other shape."""
    if m.dim() != 4 or m.shape[1] != 1 or m.shape[2] != 1:
        return None
    if m.shape[3] != lk or m.shape[0] not in (1, batch):
        return None
    bias = m.reshape(m.shape[0], lk)
    if bias.dtype == torch.bool:
        bias = torch.where(bias, 0.0, -1e9).to(torch.float32)
    if bias.shape[0] == 1:
        bias = bias.expand(batch, lk)
    return bias


def _composed(q, k, v, mask, dropout_p, is_causal, seed, offset):
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
                                   probs.device, probs.dtype)
    return torch.matmul(probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, dropout_state=None):
    """query/key/value: (B, L, H, D). Returns (B, L, H, D)."""
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
                                   seed=seed, offset=offset)
    else:
        out = _composed(q, k, v, attn_mask, p_eff, is_causal, seed, offset)
    return out.transpose(1, 2)
