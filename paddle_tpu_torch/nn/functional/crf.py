"""Linear-chain CRF: the sequence negative log-likelihood and Viterbi
decoding. Counterpart of ``paddle_tpu/nn/functional/crf.py``.

Sequences are padded-dense (B, T, D) with lengths, batched over B on the
device. The transition is the reference's (D + 2, D): row 0 the start
weights, row 1 the stop weights, rows 2.. the weights ``w[i, j]`` of tag
i -> tag j.

``linear_chain_crf`` runs the forward algorithm in log space, T - 1 steps
of a ``logsumexp`` over (B, D, D) under autograd, which gives the
gradient (as ``jax.grad`` does for the reference's ``lax.scan``).
``crf_decoding`` keeps each step's argmax pointers on the device and
backtracks with ``gather``; it reads nothing back to the host. A padded
step keeps its score and points each tag to itself, so the backtrack
passes through it; padded positions of the path are 0.
"""
import torch

__all__ = ['linear_chain_crf', 'crf_decoding']


def _prepare(emission, transition, length):
    B, T, D = emission.shape
    if length is None:
        length = torch.full((B,), T, dtype=torch.int64,
                            device=emission.device)
    length = torch.as_tensor(length).to(emission.device, torch.int64,
                                        non_blocking=True)
    mask = torch.arange(T, device=emission.device)[None] < length[:, None]
    return transition[0], transition[1], transition[2:], length, mask


def linear_chain_crf(emission, label, transition, length=None):
    """Each sequence's CRF negative log-likelihood -> (B, 1); ``mean()`` it
    for the training cost. ``emission`` (B, T, D) tag scores, ``label``
    (B, T) tags, ``length`` (B,) (all T when None). Differentiable in
    ``emission`` and ``transition``."""
    start, stop, w, length, mask = _prepare(emission, transition, length)
    T = emission.shape[1]
    alpha = start + emission[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + w, dim=1) + emission[:, t]
        alpha = torch.where(mask[:, t, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + stop, dim=1)
    lab = torch.as_tensor(label).to(emission.device, torch.int64)
    maskf = mask.to(emission.dtype)
    emit = (emission.gather(2, lab[..., None])[..., 0] * maskf).sum(1)
    trans = (w[lab[:, :-1], lab[:, 1:]] * maskf[:, 1:]).sum(1)
    last = lab.gather(1, (length - 1).clamp(min=0)[:, None])[:, 0]
    gold = start[lab[:, 0]] + emit + trans + stop[last]
    return (log_z - gold)[:, None]


def crf_decoding(emission, transition, length=None, label=None):
    """The best tag path under the CRF -> (B, T) int64, padded positions 0;
    with ``label``, the reference's error mask instead: 1 at the valid
    positions whose decoded tag differs from the label."""
    with torch.no_grad():
        start, stop, w, length, mask = _prepare(emission, transition, length)
        B, T, D = emission.shape
        tags = torch.arange(D, device=emission.device)
        delta = start + emission[:, 0]
        ptrs = []
        for t in range(1, T):
            best, ptr = (delta[:, :, None] + w).max(dim=1)
            keep = mask[:, t, None]
            delta = torch.where(keep, best + emission[:, t], delta)
            ptrs.append(torch.where(keep, ptr, tags))
        tag = (delta + stop).argmax(dim=1)
        path = [tag]
        for ptr in reversed(ptrs):
            tag = ptr.gather(1, tag[:, None])[:, 0]
            path.append(tag)
        path = torch.stack(path[::-1], dim=1)
        path = torch.where(mask, path, 0)
        if label is None:
            return path
        lab = torch.as_tensor(label).to(emission.device, torch.int64)
        return ((path != lab) & mask).to(torch.int64)
