"""Gradient clipping. Counterpart of ``paddle_tpu/nn/clip.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``, the
fluid aliases and ``clip_grad_norm_``).

A clip takes ``(param, grad)`` pairs and returns new pairs; a parameter
whose ``need_clip`` attribute is False (``nn.initializer.ParamAttr``)
keeps its gradient. The norms are 0-dim tensors on the gradients' device
(``torch._foreach_norm``, then one ``vector_norm`` of the stacked norms
for the global one), and so is the scale ``clip / max(norm, clip)``:
nothing is read back to the host, so a clip inside a train step never
makes the host wait for the device. A non-finite gradient gives a
non-finite norm and NaN gradients, which a loss scaler's ``ok`` select then
discards.

Not ported yet: the process-wide default of
``fluid.clip.set_gradient_clip``, which waits for ``fluid/``.
"""
import torch

__all__ = ['ClipGradBase', 'ClipGradByValue', 'ClipGradByNorm',
           'ClipGradByGlobalNorm', 'GradientClipByValue',
           'GradientClipByNorm', 'GradientClipByGlobalNorm',
           'clip_grad_norm_']


def _need_clip(p):
    return getattr(p, 'need_clip', True)


class ClipGradBase:
    def __call__(self, params_grads):
        """``params_grads``: a list of ``(param, grad tensor)``."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _need_clip(p)
                 else g) for p, g in params_grads]

    def __repr__(self):
        return f"ClipGradByValue(min={self.min}, max={self.max})"


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``, on its
    own."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        chosen = [i for i, (p, _) in enumerate(params_grads)
                  if _need_clip(p)]
        out = list(params_grads)
        if not chosen:
            return out
        grads = [params_grads[i][1] for i in chosen]
        norms = torch._foreach_norm(grads)
        # min(clip / max(norm, 1e-12), 1), the reference's order
        scales = torch._foreach_clamp_min(norms, 1e-12)
        torch._foreach_reciprocal_(scales)
        torch._foreach_mul_(scales, self.clip_norm)
        torch._foreach_clamp_max_(scales, 1.0)
        for i, g in zip(chosen, torch._foreach_mul(grads, scales)):
            out[i] = (params_grads[i][0], g)
        return out

    def __repr__(self):
        return f"ClipGradByNorm(clip_norm={self.clip_norm})"


def global_norm(grads):
    """The L2 norm of every tensor of ``grads`` together, a 0-dim tensor
    (fp32 at least)."""
    norms = torch._foreach_norm(grads)
    if len(norms) == 1:
        return norms[0].float()
    return torch.linalg.vector_norm(torch.stack([n.float() for n in norms]))


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip / max(global_norm, clip)``, the
    global norm taken over the gradients that ``need_clip``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def scale(self, grads):
        """The 0-dim scale ``clip / max(norm, clip)`` of ``grads``."""
        norm = global_norm(grads)
        return self.clip_norm / torch.clamp_min(norm, self.clip_norm)

    def __call__(self, params_grads):
        chosen = [i for i, (p, _) in enumerate(params_grads)
                  if _need_clip(p)]
        out = list(params_grads)
        if not chosen:
            return out
        grads = [params_grads[i][1] for i in chosen]
        scale = self.scale(grads)
        for i, g in zip(chosen, torch._foreach_mul(grads, scale)):
            out[i] = (params_grads[i][0], g)
        return out

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"


# fluid-era aliases
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by ``min(max_norm /
    max(total, 1e-6), 1)`` -> the total norm, a 0-dim tensor (0 when no
    parameter has a gradient)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float('inf'):
        total = torch.stack(torch._foreach_norm(grads, float('inf'))).max()
    else:
        total = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads, norm_type)), norm_type)
    if error_if_nonfinite and not torch.isfinite(total):
        raise RuntimeError("clip_grad_norm_: the total norm of the "
                           "gradients is not finite")
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-6), 1.0)
    torch._foreach_mul_(grads, scale)
    return total
