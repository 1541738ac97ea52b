"""Flat-buffer fused optimizer update. Counterpart of
``paddle_tpu/optimizer/fused.py`` (``FlatFusedUpdate``).

Every parameter lives in ONE fp32 master buffer (with matching moment
buffers), so the update is the optimizer's elementwise rule run once over
the whole buffer — a handful of torch ops, with one ``beta*_pow`` pair for
the buffer, as the reference's ``init_state = opt._init_state(flat_p)`` —
instead of ~400 per-tensor updates. The reference's update is XLA code
outside any Pallas kernel, so plain torch ops are its counterpart here
(a one-pass kernel for it is later work, ROADMAP.md).

Layout, chosen for CUDA: the reference packs a ``(rows, 1024)`` buffer,
one TPU tile a row. Here the buffer is 1-D and every parameter's segment
starts at a multiple of ``ALIGN`` = 128 elements (512 bytes in fp32, 256
in bf16 or fp16), so each segment is 16-byte aligned for the kernels'
vector accesses in any of the three dtypes; the gaps are zeros and stay
zeros (their gradient and moments are 0, so their update is 0).
``unflatten`` returns VIEWS of the buffer, no copy: the model's
parameters can be those views (``bind``), so the master owns the weights.

``compute_dtype`` (the port's addition): the dtype the train step hands
the model. ``engine.build_train_step(optimizer=FlatFusedUpdate(...,
compute_dtype=torch.bfloat16))`` casts the master to one bf16 buffer a step
(one cast), runs the model on bf16 views of it, gathers the bf16 gradients
into one flat buffer and casts that to fp32 once — ``bench.py::
bench_bert``'s flat mode. The numbers are those of casting each parameter
on its own: a cast is elementwise.

Works with every optimizer whose rule is elementwise: ``SGD``,
``Momentum``, ``Adam`` / ``AdamW`` (with ``amsgrad``), ``Adamax``,
``Adadelta``, ``Adagrad``, ``RMSProp``, ``DecayedAdagrad``, ``Ftrl``.
``Lamb``, ``LarsMomentum`` and ``Dpsgd`` are refused: their step depends
on each tensor's own norm, which one buffer does not have (the
reference's ``update`` would run Lamb's trust ratio over the whole buffer:
ROADMAP.md, Queue 3). The per-parameter settings become buffers of the
layout, built once: AdamW's decay predicate a 0/1 mask (``decay_mask``);
per-parameter learning rates (``ParamAttr(learning_rate=)``) a scale
buffer, so the rule runs at ``lr * scale``; per-parameter regularizers
an L2 and an L1 coefficient buffer. The optimizer's own
``weight_decay`` (coupled, added to the gradient) is a scalar when no
parameter has its own. The optimizer's ``grad_clip`` is applied on the
flat gradient (the reference's ``update`` drops it): ``ClipGradByValue``
elementwise, ``ClipGradByGlobalNorm`` as one reduction over the buffer
(the zeros of the gaps change no norm); ``ClipGradByNorm``, a norm per
tensor, is refused. Without a mask AdamW decays the whole buffer, as the
reference's ``_rule`` does.
"""
import math

import torch

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from ..nn.regularizer import L1Decay, L2Decay
from .optimizer import AdamW, Dpsgd, Lamb, LarsMomentum, _NoMeta

__all__ = ['FlatFusedUpdate', 'ALIGN']

ALIGN = 128    # elements: 16-byte aligned segments in fp32, bf16 and fp16


class FlatFusedUpdate:
    """Pack a ``{name: tensor}`` tree into one 1-D master buffer and run the
    optimizer rule as one fused update::

        flat = FlatFusedUpdate(opt, params)
        flat_p = flat.flatten(params)
        state = flat.init_state(flat_p)
        tree = flat.unflatten(flat_p)          # views, for the forward
        flat_p, state = flat.update(flat_p, grads, state)   # in place

    ``params_meta``: ``{name: parameter}`` whose ``ParamAttr`` settings
    (learning rate, regularizer, ``need_clip``) the update honours; by
    default ``param_values`` themselves.
    """

    def __init__(self, opt, param_values, decay_mask=None,
                 compute_dtype=None, params_meta=None):
        if isinstance(opt, (Lamb, LarsMomentum, Dpsgd)):
            raise ValueError(
                f"FlatFusedUpdate: {type(opt).__name__}'s step depends on "
                f"each tensor's own norm (a trust ratio or a per-tensor "
                f"clip), which one flat buffer does not have; update its "
                f"parameters one by one (Optimizer.functional_update)")
        if isinstance(opt._grad_clip, ClipGradByNorm):
            raise ValueError(
                "FlatFusedUpdate: ClipGradByNorm scales each gradient by its "
                "own norm, which one flat buffer does not have; use "
                "ClipGradByGlobalNorm or ClipGradByValue, or update the "
                "parameters one by one")
        self.opt = opt
        self.compute_dtype = compute_dtype
        self.names = sorted(param_values)
        self.shapes = {k: tuple(param_values[k].shape) for k in self.names}
        self.sizes = {k: math.prod(self.shapes[k]) for k in self.names}
        self.offsets = {}
        n = 0
        for k in self.names:
            self.offsets[k] = n
            n += -(-self.sizes[k] // ALIGN) * ALIGN
        self.numel = n
        first = param_values[self.names[0]] if self.names else None
        self.device = first.device if first is not None else None
        self._decay_mask = None
        if decay_mask is not None:
            if not isinstance(opt, AdamW):
                raise ValueError(
                    "decay_mask implements AdamW's decoupled decay predicate;"
                    f" it has no effect for {type(opt).__name__} — drop it or"
                    " use AdamW")
            mask = torch.zeros(n, dtype=torch.float32, device=self.device)
            for k in self.names:
                if decay_mask(k):
                    o = self.offsets[k]
                    mask[o:o + self.sizes[k]] = 1.0
            self._decay_mask = mask
        # ParamAttr settings: read from params_meta, or from the parameters
        # themselves when they carry them
        meta = params_meta if params_meta is not None else param_values
        metas = {k: meta.get(k, _NoMeta) for k in self.names}
        lrs = {k: float(getattr(m, 'optimize_attr', {}).get(
            'learning_rate', 1.0)) for k, m in metas.items()}
        # 1 in the gaps: a rule may divide by the rate (Ftrl)
        self._lr_scale = self._segments(lrs, 1.0) \
            if any(v != 1.0 for v in lrs.values()) else None
        regs = {k: getattr(m, 'regularizer', None) for k, m in metas.items()}
        self._reg_coeffs = None
        if any(r is not None for r in regs.values()):
            regs = {k: r or opt._weight_decay for k, r in regs.items()}
            self._reg_coeffs = [
                self._segments({k: r.coeff for k, r in regs.items()
                                if isinstance(r, kind)}, 0.0)
                for kind in (L2Decay, L1Decay)]
        clip_off = {k: 0.0 if getattr(m, 'need_clip', True) is False else 1.0
                    for k, m in metas.items()}
        self._clip_mask = None if all(clip_off.values()) else \
            self._segments(clip_off, 0.0) > 0

    def _segments(self, values, fill):
        """A layout buffer holding ``values[name]`` over each named segment
        and ``fill`` elsewhere."""
        buf = torch.full((self.numel,), float(fill), dtype=torch.float32,
                         device=self.device)
        for k, v in values.items():
            o = self.offsets[k]
            buf[o:o + self.sizes[k]] = v
        return buf

    # -- layout ----------------------------------------------------------
    def flatten(self, tree, dtype=torch.float32):
        """A new buffer holding ``tree``'s leaves (name order), zeros in the
        gaps."""
        flat = torch.zeros(self.numel, dtype=dtype, device=self.device)
        views = self.unflatten(flat)
        with torch.no_grad():
            torch._foreach_copy_([views[k] for k in self.names],
                                 [tree[k].detach() for k in self.names])
        return flat

    def unflatten(self, flat):
        """``{name: view}``: each segment of ``flat`` seen in its
        parameter's shape; no copy."""
        return {k: flat[self.offsets[k]:self.offsets[k] + self.sizes[k]]
                .view(self.shapes[k]) for k in self.names}

    def bind(self, params, flat):
        """Make each parameter of ``params`` (``{name: nn.Parameter}``) a
        view of ``flat``, so that the buffer owns the weights and no second
        copy is kept."""
        views = self.unflatten(flat)
        for k in self.names:
            params[k].data = views[k]

    # -- optimizer ---------------------------------------------------------
    def init_state(self, flat_p):
        return self.opt._init_state(flat_p)

    def _decay(self, names, params, lr, in_place):
        """AdamW's decoupled decay on the old values: through the mask, or
        of the whole buffer (the reference's ``AdamW._rule``)."""
        (p,) = params
        if self._decay_mask is None:
            return [p.mul_(1.0 - lr * self.opt._coeff) if in_place
                    else p * (1.0 - lr * self.opt._coeff)]
        if isinstance(lr, torch.Tensor):        # per-element rates
            mask, f = self._decay_mask * lr, -self.opt._coeff
        else:
            mask, f = self._decay_mask, -lr * self.opt._coeff
        return [p.addcmul_(mask, p, value=f) if in_place
                else torch.addcmul(p, mask, p, value=f)]

    def _regularized(self, g, p):
        """The flat gradient plus the regularizer terms: the optimizer's
        (a scalar coefficient), or each parameter's (coefficient
        buffers)."""
        if self._reg_coeffs is not None:
            l2, l1 = self._reg_coeffs
            return g.addcmul(l2, p).addcmul_(l1, torch.sign(p))
        wd = self.opt._weight_decay
        return g if wd is None else wd.add_grad_terms([g], [p])[0]

    def _clipped(self, g):
        """The optimizer's clip on the flat gradient (where ``need_clip``)."""
        clip = self.opt._grad_clip
        if clip is None:
            return g
        if isinstance(clip, ClipGradByValue):
            new = torch.clamp(g, clip.min, clip.max)
        elif isinstance(clip, ClipGradByGlobalNorm):
            part = g if self._clip_mask is None else g * self._clip_mask
            new = g * clip.scale([part])
        else:
            raise ValueError(f"FlatFusedUpdate: unknown clip {clip!r}")
        return new if self._clip_mask is None else \
            torch.where(self._clip_mask, new, g)

    @torch.no_grad()
    def update(self, flat_p, grads, state, lr=None, ok=None):
        """One update of the whole buffer, IN PLACE; ``grads`` is a flat
        buffer of ``flat_p``'s dtype or a ``{name: tensor}`` tree. ``ok``
        as in ``Optimizer.functional_update``. -> ``(flat_p, state)``."""
        lr = self.opt.get_lr() if lr is None else float(lr)
        g = grads if isinstance(grads, torch.Tensor) else \
            self.flatten(grads, flat_p.dtype)
        g = self._clipped(self._regularized(g, flat_p))
        if self._lr_scale is not None:
            lr = lr * self._lr_scale
        kw = {'decay': self._decay} if isinstance(self.opt, AdamW) else {}
        self.opt._update(['flat'], [flat_p], [g], [state], lr, ok, **kw)
        return flat_p, state
