"""Loss functionals. Counterpart of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy`` with hard labels). Plain PyTorch ops: the reference
leaves the loss to XLA."""
import torch

__all__ = ['cross_entropy']


def cross_entropy(input, label, ignore_index=-100, reduction='mean',
                  axis=-1):
    """Softmax cross entropy of ``input`` logits against integer ``label``
    (shape of ``input`` without ``axis``, or with a 1 there). Positions
    whose label is ``ignore_index`` contribute nothing, and ``'mean'``
    divides by the number of the others (at least 1), as the reference
    does."""
    if reduction not in ('mean', 'sum', 'none'):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    logp = torch.log_softmax(input, dim=axis)
    if label.dim() == logp.dim():          # (N, 1) hard labels
        label = label.squeeze(axis)
    label = label.to(torch.int64)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == 'mean':
        return loss.sum() / valid.to(logp.dtype).sum().clamp_min(1.0)
    if reduction == 'sum':
        return loss.sum()
    return loss
