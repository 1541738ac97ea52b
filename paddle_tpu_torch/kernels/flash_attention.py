"""Flash attention forward on a hand-written CUDA kernel.

Counterpart of ``paddle_tpu/kernels/flash_attention.py`` (``_fwd_kernel``,
launched by ``_flash_forward``); the kernel is ``csrc/flash_attention.cu``.
Online-softmax attention on (B, H, L, D) tensors, causal or full, with an
optional (B, Lk) additive key-padding bias, that never stores the (L, L)
score matrix.

- ``flash_attention_bhld`` -> ``o`` (what the attention layer calls);
- ``flash_attention_forward`` -> ``(o, lse)``, the outputs of the
  reference's ``_flash_forward``: ``lse`` is the fp32 per-row logsumexp,
  ``LSE_EMPTY`` for a row whose every key is masked with ``-inf`` (its
  ``o`` is 0);
- ``_attn_reference`` is the plain version, with the same fully-masked-row
  convention; CPU tensors take it.

On CUDA the kernel takes fp32, Lq == Lk, D <= 128, and q/k/v with one
common layout whose head dim is contiguous (a (B, L, H, D) tensor seen
through ``transpose(1, 2)`` needs no copy). There is no dropout on CUDA
yet (``NotImplementedError``: the Philox generator comes with the
training path) and no backward.
"""
import math

import torch

from . import _build

__all__ = ['flash_attention_bhld', 'flash_attention_forward',
           '_attn_reference', 'NEG_INF', 'LSE_EMPTY', 'MAX_HEAD_DIM']

NEG_INF = -1e30
LSE_EMPTY = 1e30   # lse of a row with no unmasked key: exp(s - LSE_EMPTY) == 0
MAX_HEAD_DIM = 128

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0

_ARGTYPES = (_build.P,) * 6 + (_build.I64,) * 7 + (_build.F32, _build.I32,
                                                   _build.P)


def _attn_reference(q, k, v, causal, scale, kpad_bias=None, dropout_p=0.0):
    """Plain attention on (B, H, L, D) -> ``(o, lse)`` with the kernel's
    conventions: masked causal scores are ``NEG_INF``, the row max starts
    at ``NEG_INF`` (so a row of ``-inf`` scores gets ``o = 0`` and
    ``lse = LSE_EMPTY`` instead of NaN), and dropout, when asked, falls on
    the normalised probabilities."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kpad_bias is not None:
        s = s + kpad_bias.float()[:, None, None, :]
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout_p > 0.0:
        p = torch.nn.functional.dropout(p, dropout_p, training=True)
    denom = l.clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / denom
    lse = torch.where(l > 0, m + torch.log(denom),
                      torch.full_like(l, LSE_EMPTY))
    return o.to(q.dtype), lse.squeeze(-1)


def _launch(q, k, v, kpad_bias, causal, scale, want_lse):
    global launches
    b, h, L, d = q.shape
    for t, name in ((q, 'q'), (k, 'k'), (v, 'v')):
        if t.dim() != 4 or tuple(t.shape) != (b, h, L, d):
            raise ValueError(f"flash attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(b, h, L, d)} "
                             "(B, H, L, D) with Lq == Lk")
        _build.require(t, f'flash attention: {name}', q.device,
                       contiguous=False)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention: head dim {d} > {MAX_HEAD_DIM}")
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)              # keeps q's strides
    if o.stride() != q.stride():
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = torch.empty_like(q)
    if kpad_bias is not None:
        kpad_bias = kpad_bias.to(torch.float32).contiguous()
        _build.require(kpad_bias, 'flash attention: kpad_bias', q.device,
                       (b, L))
    lse = (torch.empty((b, h, L), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if q.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        _build.call('ptt_flash_attention_fwd', _ARGTYPES, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(),
                    None if kpad_bias is None else kpad_bias.data_ptr(),
                    o.data_ptr(), None if lse is None else lse.data_ptr(),
                    b * h, L, d, h, q.stride(0), q.stride(1), q.stride(2),
                    float(scale), int(bool(causal)),
                    _build.stream(q.device))
    launches += 1
    return o, lse


def _forward(q, k, v, causal, scale, kpad_bias, dropout_p, want_lse):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == 'cpu':
        return _attn_reference(q, k, v, causal, scale, kpad_bias, dropout_p)
    if dropout_p > 0.0:
        raise NotImplementedError(
            "flash attention: dropout_p > 0 on CUDA needs the in-kernel "
            "Philox dropout of the training path, not ported yet")
    return _launch(q, k, v, kpad_bias, causal, scale, want_lse)


def flash_attention_forward(q, k, v, causal=False, scale=None,
                            kpad_bias=None, dropout_p=0.0):
    """Attention on (B, H, L, D) -> ``(o, lse)``; lse is (B, H, L) fp32."""
    return _forward(q, k, v, causal, scale, kpad_bias, dropout_p, True)


def flash_attention_bhld(q, k, v, causal=False, scale=None, kpad_bias=None,
                         dropout_p=0.0):
    """Attention on (B, H, L, D) -> ``o``. ``kpad_bias``: optional (B, Lk)
    additive key-padding bias (0 keeps a key, a large negative value or
    ``-inf`` masks it)."""
    return _forward(q, k, v, causal, scale, kpad_bias, dropout_p, False)[0]
