"""Pipeline parallelism: the GPipe microbatch schedule over the ``'pipe'``
axis. Counterpart of ``paddle_tpu/distributed/pipeline.py``
(``pipeline_apply``, ``stack_stage_params``, ``stage_pspec``,
``num_stages``).

The reference runs one SPMD program: stage weights stacked on a leading
``[n_stages, ...]`` dim and sharded over the pipe axis, activations
rotated stage to stage + 1 with ``lax.ppermute`` inside a ``lax.scan`` of
``n_micro + n_stages - 1`` ticks, the backward by autodiff through it. The
port runs **one process a stage**:

- rank s of the pipe axis runs stage s (its slice of the stacked
  parameters, ``stacked[k][s]``) in the fill/drain schedule: at tick t it
  runs microbatch ``t - s`` when there is one (stage 0 takes it from the
  input, the others from what their predecessor sent at tick t - 1), and
  every rank sends its activation one stage on (``collective.ppermute``
  over the pipe axis, every tick, as the reference's rotation);
- the last stage keeps the drained microbatches, and their sum over the
  pipe axis (an all-reduce: the reference's ``psum`` of the last stage's
  copy) gives every rank the output;
- the backward runs the schedule in reverse: the last stage starts from
  the output's gradient, each stage sends its input's gradient one stage
  back, and stage 0's input gradients, all-reduced over the pipe axis,
  are ``x``'s (replicated code before the pipeline sees the global one).
  Each rank's stacked parameters get the gradient of its own stage's
  slice (zeros elsewhere);
- ``checkpoint=True`` keeps only each stage's input a microbatch and
  recomputes the stage in the backward, as ``jax.checkpoint`` does; the
  dropout states replay their masks in the recompute;
- without a pipe axis of more than one rank every stacked stage runs in
  sequence on each microbatch (the reference's fallback), and its errors
  are the reference's.

``x`` is this data replica's batch (the reference's ``data_spec='auto'``
splits a global batch over a data axis; in the port each rank feeds its
own rows, as everywhere); it must divide into ``n_microbatches``.
Stages are homogeneous: one ``stage_fn(params, mb) -> mb`` whose output
has its input's shape.
"""
import torch

from . import collective, env

__all__ = ['pipeline_apply', 'stack_stage_params', 'stage_pspec',
           'num_stages', 'schedule']


def num_stages(mesh=None, axis=env.PIPE_AXIS):
    if mesh is not None and hasattr(mesh, 'shape') and \
            isinstance(mesh.shape, dict):
        return int(mesh.shape.get(axis, 1))
    return env.get_world_size(axis)


def stack_stage_params(per_stage_params):
    """``[{name: value} per stage]`` -> ``{name: stacked [n_stages, ...]}``."""
    keys = per_stage_params[0].keys()
    return {k: torch.stack([torch.as_tensor(p[k]) for p in per_stage_params])
            for k in keys}


def stage_pspec(stacked_params, axis=env.PIPE_AXIS):
    """Specs putting the stacked stage dim on the pipe axis."""
    return {k: (axis,) + (None,) * (v.dim() - 1)
            for k, v in stacked_params.items()}


def schedule(n_stages, n_micro):
    """The ticks of the GPipe fill/drain schedule: ``n_micro + n_stages -
    1``, and the bubble, the share of stage-ticks with no microbatch:
    ``(n_stages - 1) / (n_micro + n_stages - 1)``."""
    ticks = n_micro + n_stages - 1
    return {'ticks': ticks, 'bubble': (n_stages - 1) / ticks}


def _marks():
    from ..kernels.philox import live_states
    return {s: s.offset for s in live_states()}


def _replay(marks):
    for s, off in marks.items():
        s.offset = off


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, names, axis, n_micro, checkpoint, x,
                *leaves):
        S, s = env.get_world_size(axis), env.get_rank(axis)
        params = dict(zip(names, leaves))
        micro = x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])
        fwd = [(i, (i + 1) % S) for i in range(S)]
        state = torch.zeros_like(micro[0])
        out = torch.zeros_like(micro)
        inputs, graphs, marks = {}, {}, {}
        for t in range(n_micro + S - 1):
            m = t - s
            y = torch.zeros_like(state)
            if 0 <= m < n_micro:
                inp = (micro[m] if s == 0 else state).detach()
                inputs[m], marks[m] = inp, _marks()
                if checkpoint:
                    y = stage_fn(params, inp)
                else:
                    with torch.enable_grad():
                        leaf = inp.requires_grad_()
                        own = {k: v.detach().requires_grad_()
                               for k, v in params.items()}
                        y_g = stage_fn(own, leaf)
                    graphs[m] = (leaf, own, y_g)
                    y = y_g.detach()
                if s == S - 1:
                    out[m] = y
            state = collective.ppermute(y, fwd, axis)
        collective.all_reduce(out, axis=axis)     # the last stage's, to all
        ctx.stage_fn, ctx.names, ctx.axis = stage_fn, names, axis
        ctx.n_micro, ctx.checkpoint = n_micro, checkpoint
        ctx.inputs, ctx.graphs, ctx.marks = inputs, graphs, marks
        ctx.save_for_backward(*leaves)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        leaves = ctx.saved_tensors
        axis, n_micro = ctx.axis, ctx.n_micro
        S, s = env.get_world_size(axis), env.get_rank(axis)
        gm = g.reshape((n_micro, g.shape[0] // n_micro) + g.shape[1:])
        back = [((i + 1) % S, i) for i in range(S)]
        grads = [torch.zeros_like(v) for v in leaves]
        dx = torch.zeros_like(gm)
        dstate = torch.zeros_like(gm[0])
        for t in reversed(range(n_micro + S - 1)):
            m = t - s
            d_in = torch.zeros_like(dstate)
            if 0 <= m < n_micro:
                dy = gm[m] if s == S - 1 else dstate
                if ctx.checkpoint:
                    now = _marks()
                    _replay(ctx.marks[m])
                    with torch.enable_grad():
                        leaf = ctx.inputs[m].detach().requires_grad_()
                        own = {k: v.detach().requires_grad_()
                               for k, v in zip(ctx.names, leaves)}
                        y = ctx.stage_fn(own, leaf)
                    _replay(now)
                else:
                    leaf, own, y = ctx.graphs.pop(m)
                got = torch.autograd.grad(
                    y, [leaf] + [own[k] for k in ctx.names], dy,
                    allow_unused=True)
                d_in = got[0] if got[0] is not None else d_in
                for acc, gr in zip(grads, got[1:]):
                    if gr is not None:
                        acc += gr
                if s == 0:
                    dx[m] = d_in
            dstate = collective.ppermute(d_in, back, axis)
        dx = dx.reshape(g.shape)
        if ctx.needs_input_grad[5]:
            collective.all_reduce(dx, axis=axis)  # stage 0's, to all
        else:
            dx = None
        ctx.inputs = ctx.graphs = None
        return (None,) * 5 + (dx,) + tuple(grads)


def pipeline_apply(stage_fn, stacked_params, x, n_microbatches, mesh=None,
                   axis=env.PIPE_AXIS, checkpoint=True, data_spec='auto'):
    """Run ``x`` through the stacked stages with the GPipe schedule (see
    the module docstring) -> the output, on every rank, differentiable in
    ``x`` and ``stacked_params``.

    ``stage_fn(params, mb) -> mb``: one stage on one microbatch;
    ``stacked_params``: ``{name: [n_stages, ...]}``; ``x``: ``[batch,
    ...]``, the batch divisible by ``n_microbatches``. ``mesh`` and
    ``data_spec`` are the reference's arguments (the pipe axis is the
    installed mesh's; ``data_spec`` must be ``'auto'``, None or ``()``)."""
    if data_spec not in ('auto', None, ()):
        raise ValueError(f"pipeline_apply: data_spec={data_spec!r}: each "
                         f"rank feeds its own batch (data_spec='auto')")
    S = num_stages(mesh, axis)
    names = list(stacked_params)
    n_stacked = stacked_params[names[0]].shape[0]
    if S <= 1:
        # no pipe axis: every stacked stage in sequence on each microbatch
        outs = []
        for mb in torch.chunk(x, n_microbatches):
            for i in range(n_stacked):
                mb = stage_fn({k: v[i] for k, v in stacked_params.items()},
                              mb)
            outs.append(mb)
        return torch.cat(outs)
    if n_stacked != S:
        raise ValueError(
            f"stacked stage dim ({n_stacked}) != mesh '{axis}' size ({S})")
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(
            f"local (per-data-replica) batch {B} not divisible by "
            f"{n_microbatches} microbatches; shrink n_microbatches or grow "
            f"the batch")
    s = env.get_rank(axis)
    leaves = [stacked_params[k][s] for k in names]
    return _GPipe.apply(stage_fn, names, axis, int(n_microbatches),
                        bool(checkpoint), x, *leaves)
