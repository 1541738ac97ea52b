"""Autoregressive generation utilities: greedy, top-k and top-p sampling.
Counterpart of ``paddle_tpu/text/generation.py``.

``top_k_logits``, ``top_p_logits`` and ``greedy_token`` compute what the
reference computes: the filters set what they drop to ``-1e9``, and
``torch.argmax``, like ``jnp.argmax``, returns the first maximum. No
function here reads a value back to the host, so a decode loop on the
device runs them without a sync.

``sample_token`` draws from an explicit ``torch.Generator`` where the
reference takes a JAX key, by the same Gumbel-max rule as
``jax.random.categorical`` (``argmax(logits + gumbel)``). JAX's threefry
stream cannot be reproduced in torch, so a sampled token equals the
reference's only in distribution, not draw for draw.
"""
import torch

__all__ = ['top_k_logits', 'top_p_logits', 'sample_token', 'greedy_token']

_NEG = -1e9


def top_k_logits(logits, k):
    """Mask all but the k largest logits to -1e9. logits: (..., V)."""
    if k is None or k <= 0:
        return logits
    k = min(int(k), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, _NEG), logits)


def top_p_logits(logits, p):
    """Nucleus filtering: keep the smallest prefix of the sorted vocab whose
    cumulative probability reaches p. logits: (..., V)."""
    if p is None or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose cumulative mass *before* them is < p (always >= 1
    # kept)
    keep = cum - probs < p
    cutoff_idx = keep.sum(dim=-1, keepdim=True) - 1
    # p <= 0 keeps nothing: index -1, which jnp.take_along_axis reads as
    # the last (smallest) logit, so nothing is masked
    cutoff_idx = cutoff_idx % logits.shape[-1]
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits < cutoff, torch.full_like(logits, _NEG),
                       logits)


def greedy_token(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(logits, generator, temperature=1.0, top_k=None,
                 top_p=None):
    """Sample one token per row from filtered logits (B, V), drawing the
    Gumbel noise from ``generator`` (a ``torch.Generator`` on the logits'
    device, or None for that device's default one)."""
    logits = logits.to(torch.float32)
    if temperature is not None and temperature != 1.0:
        logits = logits / max(float(temperature), 1e-6)
    logits = top_k_logits(logits, top_k)
    logits = top_p_logits(logits, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    # jax.random.gumbel draws u in [tiny, 1): -log(-log(u)) stays finite
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
