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

Works with ``Adam`` and ``AdamW``; AdamW's decay predicate becomes a 0/1
mask buffer (``decay_mask``), and coupled (L2) ``weight_decay`` is added
to the gradient first, as in the reference. Without a mask AdamW decays
the whole buffer, as the reference's ``_rule`` does.
"""
import math

import torch

from .optimizer import AdamW

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
    """

    def __init__(self, opt, param_values, decay_mask=None,
                 compute_dtype=None):
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
        f = -lr * self.opt._coeff
        return [p.addcmul_(self._decay_mask, p, value=f) if in_place
                else torch.addcmul(p, self._decay_mask, p, value=f)]

    @torch.no_grad()
    def update(self, flat_p, grads, state, lr=None, ok=None):
        """One update of the whole buffer, IN PLACE; ``grads`` is a flat
        buffer of ``flat_p``'s dtype or a ``{name: tensor}`` tree. ``ok``
        as in ``Optimizer.functional_update``. -> ``(flat_p, state)``."""
        lr = self.opt.get_lr() if lr is None else float(lr)
        g = grads if isinstance(grads, torch.Tensor) else \
            self.flatten(grads, flat_p.dtype)
        wd = self.opt._weight_decay
        if wd is not None:
            g = g + wd * flat_p
        decay = self._decay if isinstance(self.opt, AdamW) else None
        self.opt._update(['flat'], [flat_p], [g], [state], lr, ok,
                         decay=decay)
        return flat_p, state
