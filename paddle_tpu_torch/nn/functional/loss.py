"""Loss functionals. Counterpart of ``paddle_tpu/nn/functional/loss.py``.
Plain PyTorch ops: the reference leaves the losses to XLA. Each follows
the reference's formula: its clamps (``binary_cross_entropy``'s 1e-12,
``kl_div``'s 1e-30), its ``'mean'`` of a weighted loss (divided by the
weights of the valid positions), ``'batchmean'``, ``ctc_loss``'s softmax
over raw logits and its ``'mean'`` over label lengths."""
import torch

__all__ = ['cross_entropy', 'softmax_with_cross_entropy',
           'binary_cross_entropy', 'binary_cross_entropy_with_logits',
           'l1_loss', 'mse_loss', 'smooth_l1_loss', 'nll_loss', 'kl_div',
           'margin_ranking_loss', 'log_loss', 'sigmoid_focal_loss',
           'ctc_loss', 'square_error_cost', 'hinge_embedding_loss',
           'cosine_embedding_loss', 'npair_loss', 'huber_loss',
           'triplet_margin_loss']


def _reduce(out, reduction):
    if reduction == 'mean':
        return out.mean()
    if reduction == 'sum':
        return out.sum()
    return out


def _hard_label(label, ndim, axis):
    if label.dim() == ndim:                # (N, 1) hard labels
        label = label.squeeze(axis)
    return label.to(torch.int64)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction='mean', soft_label=False, axis=-1,
                  use_softmax=True):
    """Softmax cross entropy of ``input`` logits against integer ``label``
    (shape of ``input`` without ``axis``, or with a 1 there) or, with
    ``soft_label``, a distribution. Positions whose label is
    ``ignore_index`` contribute nothing, and ``'mean'`` divides by the
    number of the others (at least 1), or with ``weight`` by their class
    weights' sum, as the reference does. ``use_softmax=False`` takes
    ``input`` as probabilities."""
    if reduction not in ('mean', 'sum', 'none'):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    logp = torch.log_softmax(input, dim=axis) if use_softmax \
        else torch.log(torch.clamp_min(input, 1e-30))
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis)
        return _reduce(loss, reduction)
    label = _hard_label(label, logp.dim(), axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is None:
        loss = torch.where(valid, -picked, torch.zeros_like(picked))
        if reduction == 'mean':
            return loss.sum() / valid.to(logp.dtype).sum().clamp_min(1.0)
        if reduction == 'sum':
            return loss.sum()
        return loss
    cw = weight[safe]
    loss = torch.where(valid, -picked * cw, torch.zeros_like(picked))
    if reduction == 'mean':
        return loss.sum() / torch.clamp_min(
            torch.sum(cw * valid.to(logp.dtype)), 1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-position loss with ``axis`` kept (size 1), and the softmax
    with ``return_softmax``."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        li = _hard_label(label, logits.dim(), axis)
        valid = (li != ignore_index).unsqueeze(axis)
        safe = torch.where(li != ignore_index, li, torch.zeros_like(li))
        loss = -torch.gather(logp, axis, safe.unsqueeze(axis))
        loss = torch.where(valid, loss, torch.zeros_like(loss))
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction='mean'):
    p = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    out = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction='mean', pos_weight=None):
    max_val = torch.clamp_min(-logit, 0)
    lse = torch.log(torch.exp(-max_val) + torch.exp(-logit - max_val))
    if pos_weight is not None:
        log_weight = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_weight * (lse + max_val)
    else:
        loss = (1 - label) * logit + max_val + lse
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def l1_loss(input, label, reduction='mean'):
    return _reduce(torch.abs(input - label), reduction)


def mse_loss(input, label, reduction='mean'):
    return _reduce((input - label) ** 2, reduction)


def square_error_cost(input, label):
    return (input - label) ** 2


def smooth_l1_loss(input, label, reduction='mean', delta=1.0):
    d = torch.abs(input - label)
    out = torch.where(d < delta, 0.5 * (input - label) ** 2 / delta,
                      d - 0.5 * delta) * delta
    return _reduce(out, reduction)


def huber_loss(input, label, delta=1.0, reduction='mean'):
    d = torch.abs(input - label)
    out = torch.where(d <= delta, 0.5 * (input - label) ** 2,
                      delta * (d - 0.5 * delta))
    return _reduce(out, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction='mean'):
    """``input`` log-probabilities (N, C) or (N, C, d1, ...)."""
    y = label.to(torch.int64)
    valid = y != ignore_index
    safe = torch.where(valid, y, torch.zeros_like(y))
    logp = input.movedim(1, -1) if input.dim() > 2 else input
    loss = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    cw = None
    if weight is not None:
        cw = weight[safe]
        loss = loss * cw
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == 'mean':
        v = valid.to(loss.dtype)
        denom = torch.sum(cw * v) if cw is not None else torch.sum(v)
        return loss.sum() / torch.clamp_min(denom, 1e-12)
    if reduction == 'sum':
        return loss.sum()
    return loss


def kl_div(input, label, reduction='mean'):
    out = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == 'batchmean':
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction='mean'):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


def log_loss(input, label, epsilon=1e-4):
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log(1 - input + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction='sum'):
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0) - logit * label + \
        torch.log1p(torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction='mean'):
    out = torch.where(label == 1., input, torch.clamp_min(margin - input, 0.))
    return _reduce(out, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction='mean'):
    cos = torch.sum(input1 * input2, -1) / torch.clamp_min(
        torch.linalg.norm(input1, dim=-1) * torch.linalg.norm(input2, dim=-1),
        1e-12)
    out = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin, 0.))
    return _reduce(out, reduction)


def _pnorm(v, p):
    return torch.linalg.vector_norm(v, ord=p, dim=-1)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction='mean'):
    d_ap = _pnorm(input - positive + epsilon, p)
    d_an = _pnorm(input - negative + epsilon, p)
    if swap:
        d_an = torch.minimum(d_an, _pnorm(positive - negative + epsilon, p))
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.), reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    y = labels.reshape(-1, 1)
    target = (y == y.T).to(anchor.dtype)
    target = target / target.sum(dim=1, keepdim=True)
    ce = -torch.mean(torch.sum(target * torch.log_softmax(sim, dim=1),
                               dim=1))
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, 1)) +
                    torch.mean(torch.sum(positive * positive, 1))) * 0.25
    return ce + reg


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction='mean', norm_by_times=False):
    """CTC of (T, N, C) raw logits (the softmax is taken here, as the
    reference's warpctc does) against (N, S) labels: the reference's
    forward recursion in log space, one time step a loop turn; ``'mean'``
    averages the losses divided by their label lengths."""
    logp = torch.log_softmax(log_probs, dim=-1)
    T, N, _ = logp.shape
    S = labels.shape[1]
    ext = 2 * S + 1
    dev, dt = logp.device, logp.dtype
    neg_inf = torch.tensor(-1e30, dtype=dt, device=dev)
    ext_labels = torch.full((N, ext), blank, dtype=torch.int64, device=dev)
    ext_labels[:, 1::2] = labels.to(torch.int64)
    lab_len = label_lengths.to(torch.int64)
    in_len = input_lengths.to(torch.int64)
    rows = torch.arange(N, device=dev)
    alpha = torch.full((N, ext), -1e30, dtype=dt, device=dev)
    alpha[:, 0] = logp[0, rows, blank]
    alpha[:, 1] = torch.where(lab_len > 0, logp[0, rows, ext_labels[:, 1]],
                              neg_inf)
    same2 = torch.cat([torch.ones((N, 2), dtype=torch.bool, device=dev),
                       ext_labels[:, 2:] == ext_labels[:, :-2]], dim=1)
    pad1 = torch.full((N, 1), -1e30, dtype=dt, device=dev)
    pad2 = torch.full((N, 2), -1e30, dtype=dt, device=dev)
    for t in range(1, T):
        s1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        s2 = torch.where(same2, neg_inf,
                         torch.cat([pad2, alpha[:, :-2]], dim=1))
        merged = torch.logaddexp(torch.logaddexp(alpha, s1), s2)
        new = merged + torch.gather(logp[t], 1, ext_labels)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end1 = 2 * lab_len
    end2 = 2 * lab_len - 1
    last = torch.logaddexp(
        alpha[rows, end1],
        torch.where(end2 >= 0, alpha[rows, torch.clamp_min(end2, 0)],
                    neg_inf))
    loss = -last
    if reduction == 'mean':
        return torch.mean(loss / torch.clamp_min(lab_len.to(dt), 1.0))
    if reduction == 'sum':
        return loss.sum()
    return loss
