"""Flash attention, forward and backward, on hand-written CUDA kernels.

Counterpart of ``paddle_tpu/kernels/flash_attention.py`` (``_fwd_kernel``,
``_dq_kernel`` and ``_dkv_kernel``, launched by ``_flash_forward`` and
``_flash_backward``, and the ``custom_vjp`` ``_flash``); the kernels are
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``.
Online-softmax attention on (B, H, L, D) tensors, causal or full, with an
optional (B, Lk) additive key-padding bias and dropout on the normalised
probabilities, that never stores an (L, L) matrix in either direction.

- ``flash_attention_bhld`` -> ``o`` (what the attention layer calls). When
  a gradient is wanted it goes through a registered op
  (``torch.library.custom_op``, ``paddle_tpu_torch::flash_attention``)
  whose autograd saves ``(q, k, v, o, lse)`` and the dropout ``(seed,
  offset)``, never a mask, and whose backward computes ``delta = rowsum(dO * O)`` in a torch
  op (as the reference does) and launches the dQ and the dK/dV kernel. The
  bias gets no gradient;
- ``flash_attention_forward`` -> ``(o, lse)``, the outputs of the
  reference's ``_flash_forward``: ``lse`` is the fp32 per-row logsumexp,
  ``LSE_EMPTY`` for a row whose every key is masked with ``-inf`` (its
  ``o`` is 0 and its gradients are 0);
- ``flash_attention_backward`` -> ``(dq, dk, dv)`` from ``(q, k, v, o, lse,
  dO)``, the reference's ``_flash_backward``, through ``flash_attention_dq``
  and ``flash_attention_dkv``, the wrappers of the two backward kernels;
- ``_attn_reference``, ``_dq_reference`` and ``_dkv_reference`` are the
  plain versions, with the same conventions and the same Philox mask; CPU
  tensors take them.

The dropout mask is a function of ``(seed, offset)`` and the element
(b * H + h, query row, key column) — see ``philox.py`` — so ``dropout_p >
0`` needs both. On CUDA the kernels take fp32, bf16 or fp16 (q, k, v and
dO in one dtype; ``lse``, ``delta`` and the key bias fp32), Lq == Lk, D <= 128,
and q/k/v with one common layout whose head dim is contiguous (a (B, L, H,
D) tensor seen through ``transpose(1, 2)`` needs no copy); the outputs and
gradients come back in that dtype and layout.

At bf16 and fp16 the arithmetic is the reference's: scores, softmax
statistics and every accumulator are fp32, and P (forward), P dropped and
dS (backward) are rounded to the input dtype just before the products that
take them, where the reference casts them (``flash_attention.py:154, :254,
:316, :319``). The plain versions round at the same points; at fp32 the
rounding is the identity. At fp16 a P or dS past 65504 rounds to ``inf``
there, as the reference's cast does (a scaled loss's gradient can reach it;
the loss scaler then skips the step). The fp32 kernels compute every
product as 3xTF32 on the tensor cores (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``), within ~2^-21 of each fp32 product; their
plain versions are still ``_attn_reference``, ``_dq_reference`` and
``_dkv_reference``. Every kernel rounds its scores as ``_scores`` does
(``dot * scale``, then ``+ bias``) and runs the softmax in natural units.
"""
import math
from typing import Optional, Tuple

import torch

from . import _build
from .philox import keep_scale

__all__ = ['flash_attention_bhld', 'flash_attention_forward',
           'flash_attention_backward', 'flash_attention_dq',
           'flash_attention_dkv', '_attn_reference', '_dq_reference',
           '_dkv_reference', 'NEG_INF', 'LSE_EMPTY', 'MAX_HEAD_DIM']

NEG_INF = -1e30
LSE_EMPTY = 1e30   # lse of a row with no unmasked key: exp(s - LSE_EMPTY) == 0
MAX_HEAD_DIM = 128

_FWD_ARGTYPES = (_build.P,) * 6 + (_build.I64,) * 7 + \
    (_build.F32, _build.I32) + _build.DROPOUT_ARGTYPES + (_build.I32,
                                                         _build.P)
_DQ_ARGTYPES = (_build.P,) * 8 + (_build.I64,) * 10 + \
    (_build.F32, _build.I32) + _build.DROPOUT_ARGTYPES + (_build.I32,
                                                         _build.P)
_DKV_ARGTYPES = (_build.P,) + _DQ_ARGTYPES


def _check_dropout(dropout_p, seed, offset):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash attention: dropout_p must be in [0, 1), "
                         f"got {dropout_p}")
    if dropout_p > 0.0 and (seed is None or offset is None):
        raise ValueError("flash attention: dropout_p > 0 needs the Philox "
                         "seed and offset of this call (DropoutState.next())")


def _scores(q, k, causal, scale, kpad_bias):
    """Masked scores (B, H, L, L) in the compute type, as the kernels
    build them."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if kpad_bias is not None:
        s = s + kpad_bias.to(ct)[:, None, None, :]
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float('-inf'))
    return s


def _rounded(t, dtype):
    """``t`` after a round trip through ``dtype``: what a product whose
    operands are cast to ``dtype`` sees (the identity at fp32)."""
    return t.to(dtype).to(t.dtype)


def _attn_reference(q, k, v, causal, scale, kpad_bias=None, dropout_p=0.0,
                    seed=None, offset=None):
    """Plain attention on (B, H, L, D) -> ``(o, lse)`` with the kernel's
    conventions: scores above the causal diagonal are ``-inf`` (the
    reference's ``NEG_INF`` there gives the same zero weight on every row
    with a finite score), the row max starts at ``NEG_INF`` (so a row of
    ``-inf`` scores gets ``o = 0`` and ``lse = LSE_EMPTY`` instead of
    NaN), and dropout, when asked, falls on
    the normalised probabilities with the Philox mask of ``(seed,
    offset)``. Unnormalised P, dropped, is rounded to ``v``'s dtype before
    the P.V product, as the reference rounds it."""
    _check_dropout(dropout_p, seed, offset)
    s = _scores(q, k, causal, scale, kpad_bias)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if dropout_p > 0.0:
        p = p * keep_scale(p.shape, dropout_p, seed, offset, p.device,
                           p.dtype)
    denom = l.clamp_min(1e-30)
    o = torch.matmul(_rounded(p, v.dtype), v.to(p.dtype)) / denom
    lse = torch.where(l > 0, m + torch.log(denom),
                      torch.full_like(l, LSE_EMPTY))
    return o.to(q.dtype), lse.squeeze(-1)


def _p_ds(q, k, v, do, lse, delta, causal, scale, kpad_bias, dropout_p, seed,
          offset):
    """``(P * keep/(1-p), dS)`` written out as (B, H, L, L) matrices: P is
    rebuilt from ``lse``, ``dS = P * (dP * keep/(1-p) - delta)``; both
    rounded to the input dtype, which the products that take them read."""
    s = _scores(q, k, causal, scale, kpad_bias)
    p = torch.exp(s - lse.to(s.dtype).unsqueeze(-1))
    dp = torch.matmul(do.to(s.dtype), v.to(s.dtype).transpose(-1, -2))
    p_drop = p
    if dropout_p > 0.0:
        ks = keep_scale(p.shape, dropout_p, seed, offset, p.device, p.dtype)
        p_drop = p * ks
        dp = dp * ks
    ds = p * (dp - delta.to(s.dtype).unsqueeze(-1))
    return _rounded(p_drop, q.dtype), _rounded(ds, q.dtype)


def _dq_reference(q, k, v, do, lse, delta, causal, scale, kpad_bias=None,
                  dropout_p=0.0, seed=None, offset=None):
    """Plain version of the dQ kernel: ``dq = scale * dS K``."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, kpad_bias,
                  dropout_p, seed, offset)
    return (torch.matmul(ds, k.to(ds.dtype)) * scale).to(q.dtype)


def _dkv_reference(q, k, v, do, lse, delta, causal, scale, kpad_bias=None,
                   dropout_p=0.0, seed=None, offset=None):
    """Plain version of the dK/dV kernel: ``dk = scale * dS^T Q``,
    ``dv = (P * keep/(1-p))^T dO``."""
    p_drop, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, kpad_bias,
                       dropout_p, seed, offset)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(ds.dtype)) * scale
    dv = torch.matmul(p_drop.transpose(-1, -2), do.to(ds.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def _kernel_inputs(q, k, v, kpad_bias):
    """Check q/k/v and the bias for the kernels -> ``(q, k, v, kpad_bias)``
    with one common layout whose head dim is contiguous, and which
    ``torch.empty_like`` reproduces."""
    b, h, L, d = q.shape
    # q last: a dtype that differs from q's is named before other faults
    for t, name in ((k, 'k'), (v, 'v'), (q, 'q')):
        if t.dim() != 4 or tuple(t.shape) != (b, h, L, d):
            raise ValueError(f"flash attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(b, h, L, d)} "
                             "(B, H, L, D) with Lq == Lk")
        _build.require(t, f'flash attention: {name}', q.device,
                       contiguous=False, dtype=q.dtype)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention: head dim {d} > {MAX_HEAD_DIM}")
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
            and torch.empty_like(q).stride() == q.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kpad_bias is not None:
        kpad_bias = kpad_bias.to(torch.float32).contiguous()
        _build.require(kpad_bias, 'flash attention: kpad_bias', q.device,
                       (b, L), dtype=torch.float32)
    return q, k, v, kpad_bias


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_forward(q, k, v, kpad_bias, causal, scale, dropout, want_lse):
    q, k, v, kpad_bias = _kernel_inputs(q, k, v, kpad_bias)
    b, h, L, d = q.shape
    o = torch.empty_like(q)              # keeps q's strides
    lse = (torch.empty((b, h, L), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if q.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        _build.call('flash_attention_fwd', 'ptt_flash_attention_fwd',
                    _FWD_ARGTYPES, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    _ptr(kpad_bias), o.data_ptr(), _ptr(lse), b * h, L, d, h,
                    q.stride(0), q.stride(1), q.stride(2), float(scale),
                    int(bool(causal)), *_build.dropout_args(*dropout),
                    _build.dtype_code(q), _build.stream(q.device))
    return o, lse


def _backward_inputs(q, k, v, do, lse, delta, kpad_bias):
    """Check what the two backward kernels share -> the tensors as the
    kernels take them and the arguments after the output pointers."""
    q, k, v, kpad_bias = _kernel_inputs(q, k, v, kpad_bias)
    b, h, L, d = q.shape
    _build.require(do, 'flash attention: dO', q.device, q.shape,
                   contiguous=False, dtype=q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    _build.require(lse, 'flash attention: lse', q.device, (b, h, L),
                   dtype=torch.float32)
    _build.require(delta, 'flash attention: delta', q.device, (b, h, L),
                   dtype=torch.float32)
    return q, k, v, do, lse, delta, kpad_bias


def _backward_call(kernel, argtypes, tensors, outs, causal, scale, dropout):
    q, k, v, do, lse, delta, kpad_bias = tensors
    b, h, L, d = q.shape
    if q.numel() == 0:
        return
    with torch.cuda.device(q.device):
        _build.call(kernel, 'ptt_' + kernel, argtypes, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), _ptr(kpad_bias),
                    *(o.data_ptr() for o in outs), b * h, L, d, h,
                    q.stride(0), q.stride(1), q.stride(2), do.stride(0),
                    do.stride(1), do.stride(2), float(scale),
                    int(bool(causal)), *_build.dropout_args(*dropout),
                    _build.dtype_code(q), _build.stream(q.device))


def flash_attention_dq(q, k, v, do, lse, delta, causal, scale,
                       kpad_bias=None, dropout_p=0.0, seed=None, offset=None):
    """``dq`` of attention on (B, H, L, D) from the saved ``lse`` and
    ``delta = rowsum(dO * O)``, both (B, H, L). CUDA tensors run the dQ
    kernel, CPU tensors ``_dq_reference``."""
    dropout = (float(dropout_p), seed, offset)
    _check_dropout(*dropout)
    if not _build.use_kernels(q):
        return _dq_reference(q, k, v, do, lse, delta, causal, scale,
                             kpad_bias, *dropout)
    tensors = _backward_inputs(q, k, v, do, lse, delta, kpad_bias)
    dq = torch.empty_like(tensors[0])
    _backward_call('flash_attention_dq', _DQ_ARGTYPES, tensors, (dq,),
                   causal, scale, dropout)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal, scale,
                        kpad_bias=None, dropout_p=0.0, seed=None,
                        offset=None):
    """``(dk, dv)``, as ``flash_attention_dq``. CUDA tensors run the dK/dV
    kernel, CPU tensors ``_dkv_reference``."""
    dropout = (float(dropout_p), seed, offset)
    _check_dropout(*dropout)
    if not _build.use_kernels(q):
        return _dkv_reference(q, k, v, do, lse, delta, causal, scale,
                              kpad_bias, *dropout)
    tensors = _backward_inputs(q, k, v, do, lse, delta, kpad_bias)
    dk, dv = torch.empty_like(tensors[0]), torch.empty_like(tensors[0])
    _backward_call('flash_attention_dkv', _DKV_ARGTYPES, tensors, (dk, dv),
                   causal, scale, dropout)
    return dk, dv


def _forward(q, k, v, causal, scale, kpad_bias, dropout, want_lse):
    if not _build.use_kernels(q):
        return _attn_reference(q, k, v, causal, scale, kpad_bias, *dropout)
    return _launch_forward(q, k, v, kpad_bias, causal, scale, dropout,
                           want_lse)


def flash_attention_backward(q, k, v, o, lse, do, causal=False, scale=None,
                             kpad_bias=None, dropout_p=0.0, seed=None,
                             offset=None):
    """``(dq, dk, dv)`` of attention on (B, H, L, D) from the forward's
    inputs and outputs and the output gradient ``do``: ``delta`` in a
    torch op (fp32, as the reference's), then ``flash_attention_dq`` and
    ``flash_attention_dkv``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ct = torch.promote_types(q.dtype, torch.float32)
    delta = (do.to(ct) * o.to(ct)).sum(-1)          # (B, H, L)
    rest = (lse, delta, causal, scale, kpad_bias, dropout_p, seed, offset)
    dq = flash_attention_dq(q, k, v, do, *rest)
    dk, dv = flash_attention_dkv(q, k, v, do, *rest)
    return dq, dk, dv


_U64 = 1 << 64


def _dropout(dropout_p, seed, offset):
    """The op's int64 ``seed`` and ``offset`` -> the unsigned words the
    kernels take (None where there is no dropout)."""
    if dropout_p > 0.0:
        return dropout_p, seed % _U64, offset % _U64
    return dropout_p, None, None


@torch.library.custom_op('paddle_tpu_torch::flash_attention',
                         mutates_args=())
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpad_bias: Optional[torch.Tensor], causal: bool,
                     scale: float, dropout_p: float, seed: int,
                     offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable forward -> ``(o, lse)``, an op the dispatcher
    sees: selective checkpointing (``nn/remat.py``, ``'dots'``) keeps its
    outputs by name. ``seed`` and ``offset`` come as int64 (the schema has
    no unsigned type)."""
    return _forward(q, k, v, causal, scale, kpad_bias,
                    _dropout(dropout_p, seed, offset), True)


def _save_for_backward(ctx, inputs, output):
    q, k, v, kpad_bias, causal, scale, dropout_p, seed, offset = inputs
    ctx.save_for_backward(q, k, v, *output, kpad_bias)
    # lse gets no gradient: no zero tensor is made for it
    ctx.set_materialize_grads(False)
    ctx.args = (causal, scale)
    ctx.dropout = _dropout(dropout_p, seed, offset)


def _flash_attention_backward(ctx, g, _):
    if g is None:                   # o took no gradient either
        return (None,) * 9
    q, k, v, o, lse, kpad_bias = ctx.saved_tensors
    causal, scale = ctx.args
    dq, dk, dv = flash_attention_backward(
        q, k, v, o, lse, g, causal, scale, kpad_bias, *ctx.dropout)
    return dq, dk, dv, None, None, None, None, None, None


_flash_attention.register_autograd(_flash_attention_backward,
                                   setup_context=_save_for_backward)


def _int64(word):
    """An unsigned 64-bit word as the int64 of the same bits."""
    return (word + (1 << 63)) % _U64 - (1 << 63)


def flash_attention_forward(q, k, v, causal=False, scale=None,
                            kpad_bias=None, dropout_p=0.0, seed=None,
                            offset=None):
    """Attention on (B, H, L, D) -> ``(o, lse)``; lse is (B, H, L) fp32.
    Not differentiable: ``flash_attention_bhld`` is."""
    dropout_p = float(dropout_p)
    _check_dropout(dropout_p, seed, offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _forward(q, k, v, causal, scale, kpad_bias,
                    (dropout_p, seed, offset), True)


def flash_attention_bhld(q, k, v, causal=False, scale=None, kpad_bias=None,
                         dropout_p=0.0, seed=None, offset=None):
    """Attention on (B, H, L, D) -> ``o``. ``kpad_bias``: optional (B, Lk)
    additive key-padding bias (0 keeps a key, a large negative value or
    ``-inf`` masks it). ``dropout_p > 0`` needs the call's Philox ``seed``
    and ``offset``. Differentiable in q, k and v."""
    dropout_p = float(dropout_p)
    _check_dropout(dropout_p, seed, offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _flash_attention(q, k, v, kpad_bias, bool(causal),
                                float(scale), dropout_p, _int64(seed or 0),
                                _int64(offset or 0))[0]
    return _forward(q, k, v, causal, scale, kpad_bias,
                    (dropout_p, seed, offset), False)[0]
