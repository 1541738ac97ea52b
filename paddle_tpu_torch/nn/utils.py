"""Weight reparameterisations. Counterpart of ``paddle_tpu/nn/utils.py``
(``weight_norm``, ``remove_weight_norm``, ``spectral_norm``).

``weight_norm(layer, name, dim)`` replaces the parameter ``name`` by
``name_g`` (the norm of each slice along ``dim``, or the whole norm for
``dim=None``) and ``name_v`` (the direction), the reference's names, and
recomputes ``name = g * v / max(||v||, 1e-12)`` before every forward (a
forward pre-hook). ``remove_weight_norm`` folds them back into one
parameter over the same ``dim``, as upstream Paddle does (the reference
renormalises over dim 0 whatever ``dim`` was: ROADMAP.md, Queue 3).
``spectral_norm`` keeps the parameter as ``name_orig`` and a
``SpectralNorm`` sublayer ``name_sn`` whose output becomes ``name``.
"""
import torch

__all__ = ['weight_norm', 'remove_weight_norm', 'spectral_norm']


def _norm_except(v, dim):
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _set_plain(layer, name, value):
    """``value`` as the plain attribute ``name`` of ``layer`` (not a
    parameter)."""
    layer._parameters.pop(name, None)
    object.__setattr__(layer, name, value)


def weight_norm(layer, name='weight', dim=0):
    w = getattr(layer, name)
    with torch.no_grad():
        g = _norm_except(w, dim).clone()
    del layer._parameters[name]
    layer.register_parameter(name + '_v', torch.nn.Parameter(w.detach()
                                                             .clone()))
    layer.register_parameter(name + '_g', torch.nn.Parameter(g))

    def hook(module, inputs):
        v, gg = getattr(module, name + '_v'), getattr(module, name + '_g')
        _set_plain(module, name, gg * v / torch.clamp_min(
            _norm_except(v, dim), 1e-12))

    layer._weight_norm = (layer.register_forward_pre_hook(hook), dim)
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name='weight'):
    handle, dim = layer._weight_norm
    handle.remove()
    del layer._weight_norm
    v = layer._parameters.pop(name + '_v')
    g = layer._parameters.pop(name + '_g')
    with torch.no_grad():
        w = g * v / torch.clamp_min(_norm_except(v, dim), 1e-12)
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, torch.nn.Parameter(w))
    return layer


def spectral_norm(layer, name='weight', n_power_iterations=1, eps=1e-12,
                  dim=None, generator=None):
    from .layer.norm import SpectralNorm
    w = getattr(layer, name)
    sn = SpectralNorm(list(w.shape), dim=0 if dim is None else dim,
                      power_iters=n_power_iterations, eps=eps,
                      device=w.device, generator=generator)
    layer.add_module(name + '_sn', sn)
    orig = layer._parameters.pop(name)
    layer.register_parameter(name + '_orig', orig)

    def hook(module, inputs):
        _set_plain(module, name, getattr(module, name + '_sn')(
            getattr(module, name + '_orig')))

    layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer
