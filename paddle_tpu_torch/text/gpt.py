"""GPT-style decoder LM. Counterpart of ``paddle_tpu/text/gpt.py``
(``GPTConfig``, ``CausalSelfAttention``, ``GPTBlock``, ``GPTModel``,
``gpt_small``).

Attribute names match the reference (``wte``, ``wpe``,
``blocks.<i>.attn.qkv``, ``blocks.<i>.mlp.0``, ``ln_f``), so its state
dict loads through ``interop.load_paddle_tpu_state`` unchanged. The head
is tied: logits are ``h @ wte.weight^T`` on the (vocab, hidden) table,
untransposed. ``wte``/``wpe`` are Normal(0, 0.02), the ``Linear``s
Xavier-uniform with zero biases, as in the reference.

Attention:

- the no-cache forward is ``F.scaled_dot_product_attention(is_causal=True)``:
  the causal flash forward kernel on CUDA tensors (the reference reaches
  its Pallas kernel only from L >= 512 on a TPU; the port has no such
  threshold);
- the cached forward (``caches``/``pos``) writes K and V into
  preallocated fp32 (B, T, H, D) buffers at ``pos`` by slice assignment.
  At ``pos = 0`` (the prefill) every query's keys are the prompt's own
  causal prefix, so attention is the causal flash forward over the
  chunk's q, k, v: the reference's composed path masks every later key
  with -1e9, which adds exactly 0 after its fp32 softmax. At ``pos > 0``
  it is plain torch, the reference's ``_cached_attention``: scores against
  the buffer, the -1e9 mask on absolute positions, an fp32 softmax. Only
  the first ``pos + S`` keys are read, since the others are masked
  (``cached_attention(..., keys=T)`` reads them all).

``pos`` is a host int: the port's decode loop runs in Python, so nothing
needs a traced offset. ``generate`` follows the reference's
``_generate_fn`` step for step as a loop on the device (see its
docstring). ``use_ring_attention=True`` runs the no-cache attention as
``distributed.ring_attention`` over the ``'seq'`` axis (its global form:
each rank takes its block of the sequence, the blocks travel the ring,
the output is all-gathered), causal and without dropout, as the
reference's; without a ``'seq'`` axis of more than one rank that is the
causal flash forward. The cached (decode) path is the same either way.
"""
import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.philox import DropoutState
from ..nn import functional as F
from ..nn import (GELU, Dropout, Embedding, LayerList, LayerNorm, Linear,
                  Sequential)
from .generation import greedy_token, sample_token

__all__ = ['GPTConfig', 'CausalSelfAttention', 'GPTBlock', 'GPTModel',
           'cached_attention', 'gpt_small']

_MASKED = -1e9      # the reference's mask value (gpt.py:96)


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, dropout=0.1,
                 use_ring_attention=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.use_ring_attention = use_ring_attention


def _host_int(pos):
    """``pos`` as a host int (a tensor is read back: one sync)."""
    return int(pos.item() if isinstance(pos, torch.Tensor) else pos)


def cached_attention(q, k_buf, v_buf, pos, keys=None):
    """The reference's composed cached attention on (B, S, H, D) queries
    at absolute positions ``pos .. pos + S - 1`` against (B, T, H, D)
    buffers that already hold this chunk's K and V: scores over the first
    ``keys`` positions (default ``pos + S``, every key a query can see),
    -1e9 on keys past each query, an fp32 softmax. -> (B, S, H, D)."""
    S = q.shape[1]
    keys = pos + S if keys is None else int(keys)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.transpose(1, 2)                          # (B, H, S, D)
    kh = k_buf[:, :keys].transpose(1, 2)            # (B, H, keys, D)
    vh = v_buf[:, :keys].transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    qpos = pos + torch.arange(S, device=q.device)
    mask = torch.arange(keys, device=q.device)[None, :] <= qpos[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, _MASKED))
    attn = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.matmul(attn.to(vh.dtype), vh).transpose(1, 2)


class CausalSelfAttention(nn.Module):
    def __init__(self, config, *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        self.use_ring = config.use_ring_attention
        self.num_heads = config.num_heads
        self.hidden = config.hidden_size
        kw = dict(device=device, generator=generator)
        self.qkv = Linear(config.hidden_size, 3 * config.hidden_size, **kw)
        self.proj = Linear(config.hidden_size, config.hidden_size, **kw)
        self.dropout = Dropout(config.dropout, dropout_state=dropout_state)

    def forward(self, x, cache=None, pos=None):
        B, L, E = x.shape
        qkv = self.qkv(x).reshape(B, L, 3, self.num_heads,
                                  E // self.num_heads)
        q, k, v = qkv.unbind(2)
        if cache is not None:
            out, cache = self._cached_attention(q, k, v, cache, pos)
            return self.dropout(self.proj(out.reshape(B, L, E))), cache
        if self.use_ring:
            from ..distributed.ring_attention import ring_attention
            out = ring_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                 causal=True).transpose(1, 2)
        else:
            # the reference passes no dropout_p: attention never drops
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=self.training)
        return self.dropout(self.proj(out.reshape(B, L, E)))

    def _cached_attention(self, q, k, v, cache, pos):
        """Write this chunk's K/V at ``pos`` (in place) and attend; see the
        module docstring. -> (out (B, S, H, D), (k_buf, v_buf))."""
        k_buf, v_buf = cache
        pos = _host_int(pos)
        S = q.shape[1]
        k_buf[:, pos:pos + S] = k.to(k_buf.dtype)
        v_buf[:, pos:pos + S] = v.to(v_buf.dtype)
        if pos == 0:
            dt = k_buf.dtype
            out = F.scaled_dot_product_attention(
                q.to(dt), k.to(dt), v.to(dt), is_causal=True,
                training=False)
        else:
            out = cached_attention(q, k_buf, v_buf, pos)
        return out, (k_buf, v_buf)


class GPTBlock(nn.Module):
    def __init__(self, config, *, device=None, generator=None,
                 dropout_state=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        E = config.hidden_size
        self.ln1 = LayerNorm(E, device=device)
        self.attn = CausalSelfAttention(config, dropout_state=dropout_state,
                                        **kw)
        self.ln2 = LayerNorm(E, device=device)
        self.mlp = Sequential(
            Linear(E, 4 * E, **kw), GELU(), Linear(4 * E, E, **kw),
            Dropout(config.dropout, dropout_state=dropout_state))

    def forward(self, x, cache=None, pos=None):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), cache, pos)
            x = x + a
            x = x + self.mlp(self.ln2(x))
            return x, cache
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class GPTModel(nn.Module):
    """Decoder LM -> logits (B, L, vocab).

    ``device=None`` builds on the CUDA device (``device='cpu'`` for the
    plain path); every initial value, then the seed of the model's
    ``dropout_state``, is drawn from ``generator`` (default: a generator on
    that device seeded with 0).
    """

    def __init__(self, config=None, *, device=None, generator=None,
                 **kwargs):
        super().__init__()
        config = config or GPTConfig(**kwargs)
        self.config = config
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.dropout_state = DropoutState(0)
        kw = dict(device=device, generator=generator)
        self.wte = Embedding(config.vocab_size, config.hidden_size,
                             std=0.02, **kw)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size,
                             std=0.02, **kw)
        self.drop = Dropout(config.dropout, dropout_state=self.dropout_state)
        self.blocks = LayerList([
            GPTBlock(config, dropout_state=self.dropout_state, **kw)
            for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, device=device)
        self.dropout_state.seed = DropoutState.from_generator(generator).seed

    def _head(self, x):
        return torch.matmul(self.ln_f(x), self.wte.weight.t())

    def forward(self, input_ids, caches=None, pos=None):
        """``caches=None``: logits of the whole sequence. With ``caches``
        (``init_caches``) and ``pos`` (the absolute position of
        ``input_ids[:, 0]``, a host int): ``(logits, caches)``, the caches
        written in place at ``pos .. pos + L - 1``."""
        L = input_ids.shape[1]
        if caches is None:
            p = torch.arange(L, device=input_ids.device)
            x = self.drop(self.wte(input_ids) + self.wpe(p)[None])
            for blk in self.blocks:
                x = blk(x)
            return self._head(x)
        pos = _host_int(pos)
        p = pos + torch.arange(L, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(p)[None])
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, pos)
            new_caches.append(cache)
        return self._head(x), new_caches

    def loss(self, input_ids, labels):
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))

    def init_caches(self, batch_size, max_len, dtype=torch.float32):
        """Preallocated zero KV buffers, per layer (k, v) (B, T, H, D), on
        the model's device (fp32, as the reference's generate makes
        them)."""
        H = self.config.num_heads
        D = self.config.hidden_size // H
        shape = (batch_size, max_len, H, D)
        dev = self.wte.weight.device
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
                for _ in range(self.config.num_layers)]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=None, top_p=None, eos_token_id=None,
                 seed=None):
        """Autoregressive generation with fixed-size KV caches -> the
        (B, L0 + max_new_tokens) int32 tokens, prompt first, on the host.

        The reference's ``_generate_fn`` (``gpt.py:221-305``) as a Python
        loop on the device: the prefill, then per new token a choice
        (greedy, or sampled from a ``torch.Generator`` on the model's
        device seeded with ``seed``, a fresh seed when None) and one model
        step, skipped after the last choice, so ``1 + (max_new_tokens - 1)``
        model steps without an early stop. Finished rows emit
        ``max(eos, 0)``; everything after a row's first eos becomes eos.
        The tokens and the output buffer stay on the device and are fetched
        once at the end: without ``eos_token_id`` the loop reads nothing
        back; with one, each step reads one all-finished flag (a host
        sync) to exit early as the reference's ``while_loop`` does. The
        model is in ``eval()`` for the call and its mode restored after.
        """
        dev = self.wte.weight.device
        if isinstance(input_ids, torch.Tensor):
            ids = input_ids.to(device=dev, dtype=torch.int64)
        else:
            ids = torch.as_tensor(np.asarray(input_ids, np.int64),
                                  device=dev)
        B, L0 = ids.shape
        max_new = int(max_new_tokens)
        T = L0 + max_new
        if T > self.config.max_seq_len:
            raise ValueError(
                f"generate length {T} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        eos = -1 if eos_token_id is None else int(eos_token_id)
        gen = None
        if do_sample:
            gen = torch.Generator(device=dev)
            if seed is None:
                gen.seed()
            else:
                gen.manual_seed(int(seed))
        temperature = 1.0 if temperature is None else float(temperature)

        def pick(lg):
            if do_sample:
                return sample_token(lg, gen, temperature, top_k, top_p)
            return greedy_token(lg)

        was_training = self.training
        self.eval()
        try:
            caches = self.init_caches(B, T)
            logits, caches = self(ids, caches, 0)
            last = logits[:, -1, :]
            out = torch.zeros((B, T), dtype=torch.int32, device=dev)
            out[:, :L0] = ids
            fin = torch.zeros((B,), dtype=torch.bool, device=dev)
            for i in range(max_new):
                tok = pick(last)
                if eos >= 0:
                    tok = torch.where(fin, torch.full_like(tok, max(eos, 0)),
                                      tok)
                    fin = fin | (tok == eos)
                out[:, L0 + i] = tok
                if i + 1 >= max_new:
                    break
                if eos >= 0 and bool(fin.all()):     # one sync a step
                    break
                logits, caches = self(tok[:, None].to(torch.int64), caches,
                                      L0 + i)
                last = logits[:, -1, :]
            if eos >= 0:
                # pad everything after each row's first eos (an early exit
                # leaves those slots unwritten)
                gen_cols = torch.arange(T, device=dev)[None, :] >= L0
                is_eos = ((out == eos) & gen_cols).to(torch.int32)
                after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
                out = torch.where(after & gen_cols,
                                  torch.full_like(out, eos), out)
            return out.cpu()
        finally:
            if was_training:
                self.train()


def gpt_small(**kwargs):
    """The reference's ``gpt_small``: hidden 768, 12 layers, 12 heads
    (vocab 50304, max_seq_len 1024 by default). ``device``/``generator``
    go to ``GPTModel``."""
    model_kw = {k: kwargs.pop(k) for k in ('device', 'generator')
                if k in kwargs}
    return GPTModel(GPTConfig(hidden_size=768, num_layers=12, num_heads=12,
                              **kwargs), **model_kw)
