"""Rank-side cases of the port's data-parallel tests, run in the ranks that
``paddle_tpu_torch.distributed.spawn`` starts (gloo, CPU).

No JAX here: a spawned rank imports this module by name, and the port's
ranks never import the reference. Each case returns plain numpy / Python
values; the test module holds them against the reference.
"""
import os
import time

import numpy as np
import torch

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
SEQ = 64
LR = 1e-3


def batches(n, b, seq=SEQ, seed=0):
    """``n`` global batches of BERT pretraining feeds (ids, token types,
    an all-ones mask, masked positions) and labels (MLM, NSP)."""
    rs = np.random.RandomState(seed)
    k = seq * 15 // 100
    out = []
    for _ in range(n):
        x = (rs.randint(0, 512, (b, seq)).astype(np.int32),
             np.zeros((b, seq), np.int32), np.ones((b, seq), np.int32),
             np.stack([rs.choice(seq, k, replace=False)
                       for _ in range(b)]).astype(np.int32))
        y = (rs.randint(0, 512, (b, k)).astype(np.int32),
             rs.randint(0, 2, (b, 1)).astype(np.int32))
        out.append((x, y))
    return out


def local(batch, rank, world):
    """This rank's slice of a global batch (every leaf on its dim 0)."""
    x, y = batch
    n = x[0].shape[0] // world

    def cut(a):
        return a[rank * n:(rank + 1) * n]
    return tuple(cut(a) for a in x), tuple(cut(a) for a in y)


def model(init=None, seed=0, **cfg):
    from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining
    net = BertForPretraining(BertConfig(**{**SMALL, **cfg}), device='cpu',
                             generator=torch.Generator().manual_seed(seed))
    if init is not None:
        with torch.no_grad():
            for k, p in net.named_parameters():
                p.copy_(torch.from_numpy(init[k]))
    return net


def weights(net):
    return {k: p.detach().numpy().copy() for k, p in net.named_parameters()}


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _feed(batch):
    x, y = batch
    return (tuple(torch.from_numpy(a) for a in x),
            tuple(torch.from_numpy(a) for a in y))


def run_steps(net, opt, data, rank, world, sharding=None, dp=False,
              steps=3, **kw):
    """``steps`` calls of ``build_train_step`` on this rank's slices ->
    (losses, full parameters, full optimizer slots, the step, state)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.engine import build_train_step
    target = dist.DataParallel(net) if dp else net
    step = build_train_step(net=target, loss=net.pretraining_loss,
                            optimizer=opt, sharding=sharding, device='cpu',
                            **kw)
    state = step.init_state()
    losses = []
    for i in range(steps):
        state, out = step(state, _feed(local(data[i % len(data)], rank,
                                              world)))
        losses.append(float(out.loss))
    full = numpy_tree(dict(step.full_params(state)))
    slots = numpy_tree(step.full_slots(state))
    return losses, full, slots, step, state


def adamw():
    from paddle_tpu_torch import optimizer as topt
    return topt.AdamW(learning_rate=LR, weight_decay=0.01)


def lamb_clip():
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    return topt.Lamb(learning_rate=LR, lamb_weight_decay=0.01,
                     grad_clip=ClipGradByGlobalNorm(1.0))


def sgd():
    from paddle_tpu_torch import optimizer as topt
    return topt.SGD(learning_rate=0.05)


CLIP_NORM = 0.5


def sgd_clip():
    """SGD with the global-norm clip at ``CLIP_NORM`` (below the gradients'
    norm, so every step clips): the cross-rank norm without Adam's
    sign-flip noise."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    return topt.SGD(learning_rate=0.05,
                    grad_clip=ClipGradByGlobalNorm(CLIP_NORM))


def join_group(mesh_shape=None, axis_names=None):
    """Every rank case: one thread (the ranks share the machine's cores,
    and a fixed count keeps the CPU kernels' order of summation) and the
    process group (with ``mesh_shape`` / ``axis_names``: that mesh)."""
    from paddle_tpu_torch import distributed as dist
    torch.set_num_threads(1)
    dist.init_parallel_env(mesh_shape, axis_names)
    return dist, dist.get_rank(), dist.get_world_size()


def _params_equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def _poisoned_loss(net, rank, victim):
    """The pretraining loss plus, on rank 1, ``1e35`` x one element of
    ``victim`` (in rank 0's piece): a finite loss whose scaled gradient is
    inf in that one element."""
    def loss_fn(params, batch):
        (x, y) = batch
        out = torch.func.functional_call(net, params, x)
        loss = net.pretraining_loss(*out, *y)
        if rank == 1:
            loss = loss + params[victim].reshape(-1)[0] * 1e35
        return loss, out
    return loss_fn


def sharding_cases(init):
    """The FSDP step at k ranks against the DataParallel step (AdamW:
    bitwise; Lamb + the global-norm clip; SGD with and without the clip),
    an inf in one rank's piece, the ranks' dropout masks with and without
    remat, the sharding gauges and the collectives a step."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.engine import build_train_step
    dist, rank, world = join_group()
    data = batches(3, 4)
    out = {}
    net = model(init)
    step = build_train_step(net=net, loss=net.pretraining_loss,
                            optimizer=adamw(),
                            sharding=dist.ShardingConfig(), device='cpu')
    state = step.init_state()
    dist.collective.reset_collective_counts()
    step(state, _feed(local(data[0], rank, world)))
    out['counts_one_step'] = dist.collective.collective_counts()
    out['pieces'] = {k: (lf.dim, lf.full_shape, lf.shard_shape)
                     for k, lf in step._shards.layout.items()}
    for name, opt in (('adamw', adamw), ('lamb', lamb_clip), ('sgd', sgd),
                      ('sgd_clip', sgd_clip)):
        f = run_steps(model(init), opt(), data, rank, world,
                      sharding=dist.ShardingConfig())
        d = run_steps(model(init), opt(), data, rank, world, dp=True)
        out[name] = {'fsdp': f[:3], 'dp': d[:3]}
    # in_shardings=: the step fed the GLOBAL batch keeps this rank's rows
    net = model(init)
    step = build_train_step(net=dist.DataParallel(net),
                            loss=net.pretraining_loss, optimizer=adamw(),
                            in_shardings=(None, ('data',)), device='cpu')
    state = step.init_state()
    out['in_shardings'] = [float(step(state, _feed(b))[1].loss)
                           for b in data]
    # an inf in rank 0's piece of the word embeddings, made by rank 1
    victim = 'bert.embeddings.word_embeddings.weight'
    net = model(init)
    scaler = GradScaler(init_loss_scaling=2.0 ** 15)
    step = build_train_step(
        _poisoned_loss(net, rank, victim), adamw(),
        params=dict(net.named_parameters()), scaler=scaler, nan_guard=True,
        sharding=dist.ShardingConfig(), device='cpu')
    state = step.init_state()
    before = numpy_tree(step.full_params(state))
    state, res = step(state, _feed(local(data[0], rank, world)))
    after = numpy_tree(step.full_params(state))
    out['poison'] = {'unchanged': _params_equal(before, after),
                     'sync': step.sync(state),
                     'finite_loss': bool(np.isfinite(float(res.loss)))}
    # dropout: where the gradients are averaged (DataParallel, a sharded
    # step) each rank its own masks, rank 0's as one process's; a model
    # that synchronises nothing draws rank 0's on every rank; remat
    # replays a rank's own
    x = _feed(local(data[0], 0, world))[0]
    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    probe = model(init, **drop).train()
    with torch.no_grad():
        out['unsynced_forward'] = probe(*x)[0].numpy()
        probe.dropout_state.offset = 0
        out['masked_forward'] = dist.DataParallel(probe)(*x)[0].numpy()
    for remat in (None, 'full'):
        net = model(init, **drop).train()
        r = run_steps(net, adamw(), data, rank, world,
                      sharding=dist.ShardingConfig(), steps=2, remat=remat)
        out[f'remat_{remat}'] = r[:2] + (net.dropout_state.rank,)
    # the sharding gauges
    obs.enable()
    net = model(init)
    step = build_train_step(net=net, loss=net.pretraining_loss,
                            optimizer=adamw(),
                            sharding=dist.ShardingConfig(), device='cpu')
    state = step.init_state()
    out['gauges'] = {k: v for k, v in obs.snapshot()['gauges'].items()
                     if k.startswith('sharding.')}
    out['info'] = step.sharding_info(state)
    obs.disable()
    obs.reset()
    return out


# the reference's PROD cases (tests/test_distributed.py): one value a rank
PROD_SIGNS = [1.0, -2.0, 3.0, -4.0, 5.0, -6.0, 7.0, 1.0]
PROD_ZERO = [1.0, -2.0, 0.0, 4.0, 5.0, 6.0, 7.0, 8.0]
PROD_INT = [1, 2, 3, 1, 2, 1, 1, 2]


def _collectives(dist, rank, n, group, dtype):
    """Each collective on ``group`` (``n`` ranks; this is its rank
    ``rank``) in ``dtype`` -> {case: numpy}."""
    c = dist.collective
    t = lambda v: torch.tensor(v, dtype=dtype)   # noqa: E731
    out = {}
    for op in ('sum', 'max', 'min', 'prod'):
        x = t([rank + 1.0])
        out[f'all_reduce_{op}'] = c.all_reduce(x, op=op, group=group)
    for name, vals in (('prod_signs', PROD_SIGNS), ('prod_zero', PROD_ZERO)):
        out[name] = c.all_reduce(t([vals[rank]]), op=c.ReduceOp.PROD,
                                 group=group)
    out['prod_int'] = c.all_reduce(
        torch.tensor([PROD_INT[rank]], dtype=torch.int32),
        op=c.ReduceOp.PROD, group=group)
    # the reference's eager closed forms on a replicated value
    out['replicated_sum'] = c.all_reduce(t([1.5, -2.0]), group=group)
    out['replicated_max'] = c.all_reduce(t([3.0]), op='max', group=group)
    out['replicated_prod'] = c.all_reduce(t([-2.0]), op=c.ReduceOp.PROD,
                                          group=group)
    gathered = []
    out['all_gather'] = c.all_gather(gathered, t([2.0 * rank, 2.0 * rank + 1]),
                                     group=group)
    out['all_gather_list'] = len(gathered)
    row = t([rank + 1.0] * n)
    out['reduce_scatter'] = c.reduce_scatter(None, row, group=group)
    out['reduce_scatter_list'] = c.reduce_scatter(
        t([0.0]), [t([rank + 1.0]) for _ in range(n)], group=group)
    mine = t([float(rank * n + j) for j in range(n)])
    out['alltoall'] = torch.stack(c.alltoall(list(mine.reshape(n, 1)),
                                             group=group)).reshape(-1)
    src = 1 if n > 1 else 0
    out['broadcast'] = c.broadcast(t([10.0 + rank]), src=src, group=group)
    red = c.reduce(t([rank + 1.0]), dst=0, group=group)
    out['reduce_dst'] = red if rank == 0 else None
    out['scatter'] = c.scatter(
        t([0.0, 0.0]), [t([float(i), -float(i)]) for i in range(n)]
        if rank == 0 else None, src=0, group=group)
    c.barrier(group=group)
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                and v.is_floating_point() else
                v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def collective_cases(dp_init, dp_x, dp_y):
    """Every collective at 4 ranks and in a group of 2, fp32 and bf16;
    send / recv; the counters; the deadline; DataParallel's gradient sync;
    the fleet metrics."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.resilience import faultinject as fi
    dist, rank, world = join_group()
    out = {}
    pair = dist.new_group([0, 1])       # every rank makes it
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split('.')[-1]
        out[f'4_{key}'] = _collectives(dist, rank, world, None, dtype)
        if rank < 2:
            out[f'2_{key}'] = _collectives(dist, rank, 2, pair, dtype)
    try:
        dist.collective.all_reduce(torch.ones(1), op='bogus')
    except ValueError as e:
        out['bogus'] = str(e)
    # point to point on a ring
    buf = torch.zeros(3)
    if rank % 2 == 0:
        dist.send(torch.full((3,), float(rank)), dst=rank + 1)
    else:
        dist.recv(buf, src=rank - 1)
    out['recv'] = buf.numpy()
    # counters: the process's own tally and the telemetry counters
    obs.enable()
    dist.collective.reset_collective_counts()
    dist.all_reduce(torch.ones(16))
    dist.all_gather(None, torch.ones(4, dtype=torch.bfloat16))
    snap = obs.snapshot()['counters']
    out['counts'] = dist.collective.collective_counts()
    out['telemetry'] = {k: v for k, v in snap.items()
                        if k.startswith('collective.')}
    obs.disable()
    obs.reset()
    # DataParallel: scale_loss + apply_collective_grads on this rank's
    # rows of the batch
    net = torch.nn.Linear(5, 3)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(dp_init[0]))
        net.bias.copy_(torch.from_numpy(dp_init[1]))
    dp = dist.DataParallel(net)
    n = dp_x.shape[0] // world
    xs = torch.from_numpy(dp_x[rank * n:(rank + 1) * n])
    ys = torch.from_numpy(dp_y[rank * n:(rank + 1) * n])
    loss = ((dp(xs) - ys) ** 2).mean()
    dp.scale_loss(loss).backward()
    dp.apply_collective_grads()
    out['dp_grad'] = net.weight.grad.numpy().T.copy()
    out['dp_names'] = [k for k, _ in dp.named_parameters()]
    # fleet metrics: distinct values a rank, and a replicated one
    m = dist
    v = np.array([rank + 1.0, 2.0 * rank])
    out['metrics'] = {
        'sum': m.sum(v), 'max': m.max(v), 'min': m.min(v),
        'acc': m.acc(np.array([rank + 1.0]), np.array([4.0])),
        'mae': m.mae(np.array([rank]), np.array([2.0])),
        'mse': m.mse(np.array([rank * 2.0]), np.array([2.0])),
        'rmse': m.rmse(np.array([rank * 2.0]), np.array([2.0])),
        'auc': m.auc(np.array([1.0, 2.0, rank + 3.0]),
                     np.array([3.0, 2.0, 1.0])),
        'replicated_sum': m.sum(np.array([1.0, 2.0])),
        'replicated_max': m.max(np.array([3.0]))}
    # the deadline: a slowed all-reduce expires on every rank, naming it,
    # before anything is issued
    prev = dist.set_timeout(0.2)
    try:
        with fi.slow_collective(0.5, ops=['all_reduce']):
            dist.all_reduce(torch.ones(1))
        out['deadline'] = None
    except dist.DistributedTimeoutError as e:
        out['deadline'] = (e.op, e.timeout, e.missing_ranks, str(e))
    finally:
        dist.set_timeout(prev)
    dist.barrier()
    return out


def hello():
    """-> (rank, world, the ranks' sum of rank + 1, backend)."""
    dist, rank, world = join_group()
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    import torch.distributed as tdist
    return rank, world, float(t), str(tdist.get_backend())


def die_on_rank1():
    """Rank 1 writes a marker to stderr and SIGKILLs itself; rank 0 waits
    at a barrier it can never pass (the supervisor kills it)."""
    import signal
    import sys
    dist, rank, world = join_group()
    if rank == 1:
        print('rank-1-last-words', file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    dist.barrier()
    return rank


def soak_batches():
    rs = np.random.RandomState(0)
    return [(rs.rand(8, 32).astype('f4'), rs.rand(8, 4).astype('f4'))
            for _ in range(6)]


def soak_rank(ckpt_dir, kill_marker, kill_at=9):
    """The elastic soak's rank: ``engine.fit(world=, rank=)`` over the same
    six batches a rank (3 epochs, a checkpoint at each epoch's end, each
    rank writing its piece, synchronously: the kill finds it committed),
    rank 1 SIGKILLing itself once, at batch
    ``kill_at`` counted across epochs (a marker file, not a sleep), and
    every generation resuming from the newest checkpoint. Run in one
    process (no spawn) it is the uninterrupted reference. -> (rank, world,
    generation, the final parameters, the dispatches resumed from)."""
    from paddle_tpu_torch import engine
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.resilience import faultinject as fi
    gen = int(os.environ.get('PADDLE_TPU_ELASTIC_GENERATION', '0'))
    if os.environ.get('PADDLE_TPU_SPAWN_WORKER') == '1':
        dist, rank, world = join_group()
    else:
        rank, world = 0, 1
    batches = soak_batches()
    maybe_die = fi.kill_rank_at_step(kill_at, kill_marker, rank=1)
    seen = [0]

    def committed():
        from paddle_tpu_torch.resilience import CheckpointManager
        return CheckpointManager(ckpt_dir).latest_step() is not None

    class Chaos:
        def __iter__(self):
            for b in batches:
                if seen[0] == kill_at and rank == 1:
                    # the death comes after rank 0 committed the epoch-1
                    # checkpoint (its manifest, a file), whatever the
                    # ranks' relative speed; bounded
                    deadline = time.monotonic() + 30.0
                    while not committed() and time.monotonic() < deadline:
                        time.sleep(0.05)
                maybe_die(seen[0])
                seen[0] += 1
                yield b

    g = torch.Generator().manual_seed(7)
    net = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Tanh(),
                              torch.nn.Linear(64, 4))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    opt = topt.Adam(learning_rate=1e-2)
    report = engine.fit(net, lambda out, y: ((out - y) ** 2).mean(), opt,
                        Chaos(), epochs=3, prefetch=0, checkpoint=ckpt_dir,
                        checkpoint_every=0, async_save=False,
                        resume_from=ckpt_dir, world=world, rank=rank,
                        preempt_save=False, device='cpu')
    return (rank, world, gen, weights(net), report['resumed_from'])


def samples(n, seed=0):
    """``n`` BERT pretraining samples ((ids, token types, mask, masked
    positions), (MLM labels, NSP label)); the global batches of
    ``fit_cases`` are consecutive runs of them."""
    rs = np.random.RandomState(seed)
    k = SEQ * 15 // 100
    ids = rs.randint(0, 512, (n, SEQ)).astype(np.int32)
    pos = np.stack([rs.choice(SEQ, k, replace=False)
                    for _ in range(n)]).astype(np.int32)
    lab = rs.randint(0, 512, (n, k)).astype(np.int32)
    nsp = rs.randint(0, 2, (n, 1)).astype(np.int32)
    return [((ids[i], np.zeros(SEQ, np.int32), np.ones(SEQ, np.int32),
              pos[i]), (lab[i], nsp[i])) for i in range(n)]


def _loader(items, batch):
    """The port's DataLoader over ``items`` with a DistributedBatchSampler
    (this rank's every world-th sample, ``batch`` of them a batch)."""
    from paddle_tpu_torch import io

    class Samples(io.Dataset):
        def __len__(self):
            return len(items)

        def __getitem__(self, i):
            return items[i]
    ds = Samples()
    return io.DataLoader(ds, batch_sampler=io.DistributedBatchSampler(
        ds, batch_size=batch), device='cpu')


DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def unsynced_fit(init, ckpt, world=None, rank=None):
    """``engine.fit(world=, rank=)`` of the 2-layer BERT at p = 0.1 (Adam,
    the same 2 global batches on every rank, one epoch, each rank writing
    its checkpoint piece into ``ckpt``): the step synchronises nothing, so
    every rank draws rank 0's masks -> (final parameters, losses)."""
    from paddle_tpu_torch import engine
    from paddle_tpu_torch import optimizer as topt
    net = model(init, **DROPOUT)
    rep = engine.fit(net, net.pretraining_loss,
                     topt.Adam(learning_rate=1e-3), batches(2, 4),
                     prefetch=0, log_every=1, checkpoint=ckpt,
                     async_save=False, preempt_save=False, world=world,
                     rank=rank, device='cpu')
    return weights(net), rep['loss']


def fit_cases(init, ref_ckpt, port_ckpt, n_samples, lr):
    """``engine.fit(sharding=)`` and ``hapi.Model.fit(strategy=)`` with
    SGD over a DistributedBatchSampler feed (2 samples a rank a batch, 2
    epochs), the first checkpointing every dispatch into ``port_ckpt``;
    the resharding restore of the reference's 4-device checkpoint in
    ``ref_ckpt`` into this rank's pieces; and ``unsynced_fit`` at p = 0.1
    (its checkpoint beside ``port_ckpt``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import engine
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.resilience import CheckpointManager
    dist, rank, world = join_group()
    items = samples(n_samples)
    out = {}
    net = model(init)
    cfg = dist.ShardingConfig()
    rep = engine.fit(net, net.pretraining_loss,
                     topt.SGD(learning_rate=lr), _loader(items, 2),
                     epochs=2, sharding=cfg, checkpoint=port_ckpt,
                     checkpoint_every=1, async_save=False, log_every=1,
                     device='cpu')
    out['engine'] = {'loss': rep['loss'], 'params': weights(net),
                     'dispatches': rep['dispatches']}
    net = model(init)
    m = pt.Model(net, device='cpu')
    m.prepare(topt.SGD(learning_rate=lr, parameters=net.named_parameters()),
              net.pretraining_loss)
    m.fit(_loader(items, 2), epochs=2, strategy=cfg, verbose=0)
    out['hapi'] = {'params': weights(net), 'jit': m._use_jit,
                   'sharded': m._jit_step_fn._shards is not None}
    got = CheckpointManager(ref_ckpt).restore(sharding=cfg)
    out['restored'] = numpy_tree(got[0])
    out['unsynced'] = unsynced_fit(init, port_ckpt + '-unsynced', world,
                                   rank)
    return out


# -- model parallelism -------------------------------------------------------

def _linear(w, b):
    """A port ``Linear`` holding the reference-layout (in, out) ``w``."""
    from paddle_tpu_torch.nn import Linear
    lin = Linear(w.shape[0], w.shape[1], device='cpu')
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.array(w.T)))
        lin.bias.copy_(torch.from_numpy(np.array(b)))
    return lin


def _grads_np(loss, tensors):
    return [g.numpy().copy() for g in torch.autograd.grad(loss, tensors)]


def tp_layer_cases(col, row, emb):
    """The tensor-parallel layers on a (1, 2) mesh, forward and backward
    (loss: the sum of the squared dense output): ``col`` / ``row`` are
    ``(w (in, out), b, x)``, ``emb`` ``(table, ids)`` -> {case: (output,
    this rank's weight and bias gradients, x's gradient)}."""
    dist, rank, world = join_group((1, 2))
    S = dist.sharding
    out = {}
    for gather in (True, False):
        lin = S.ColumnParallelLinear.from_linear(_linear(col[0], col[1]),
                                                 gather_output=gather)
        x = torch.from_numpy(col[2]).requires_grad_()
        y = lin(x)
        out[f'column_gather_{gather}'] = (y.detach().numpy().copy(), *(
            _grads_np((y ** 2).sum(), [lin.weight, lin.bias, x])))
    for parallel in (False, True):
        lin = S.RowParallelLinear.from_linear(_linear(row[0], row[1]),
                                              input_is_parallel=parallel)
        xs = row[2] if not parallel else \
            np.split(row[2], world, axis=-1)[rank]
        x = torch.from_numpy(np.ascontiguousarray(xs)).requires_grad_()
        y = lin(x)
        out[f'row_parallel_{parallel}'] = (y.detach().numpy().copy(), *(
            _grads_np((y ** 2).sum(), [lin.weight, lin.bias, x])))
    from paddle_tpu_torch.nn import Embedding
    dense = Embedding(*emb[0].shape, device='cpu')
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(emb[0]))
    vocab = S.VocabParallelEmbedding.from_embedding(dense)
    y = vocab(torch.from_numpy(emb[1]))
    out['vocab'] = (y.detach().numpy().copy(),
                    *_grads_np((y ** 2).sum(), [vocab.weight]))
    out['counts'] = dist.collective.collective_counts()
    # rules on an unmodified module: the gathered forms, the dense result
    from paddle_tpu_torch import observability as obs
    rules = {'0.weight': (None, 'model'), '0.bias': ('model',),
             '2.weight': ('model', None)}
    nets = [torch.nn.Sequential(_linear(row[0].T[:, :16], col[1]),
                                torch.nn.Tanh(),
                                _linear(row[0], row[1])) for _ in range(2)]
    S.apply_tensor_parallel(nets[1], rules)
    obs.enable()
    res = []
    for net in nets:
        x = torch.from_numpy(col[2]).requires_grad_()
        y = net(x)
        gx, = torch.autograd.grad((y ** 2).sum(), [x])
        res.append((y.detach().numpy(), gx.numpy()))
    counters = obs.snapshot()['counters']
    obs.disable()
    obs.reset()
    out['gathered'] = res
    out['kinds'] = [type(m).__name__ for m in nets[1]]
    out['counters'] = {k: v for k, v in counters.items()
                       if k.startswith('collective.model.')}
    out['rules_from'] = dist.ShardingConfig(
        tensor_parallel_degree=2).with_rules_from(nets[1]).param_rules
    out['shard_tensor'] = S.shard_tensor(torch.arange(8.0).reshape(2, 4),
                                         (None, 'model')).numpy()
    return rank, out


def _tp_bert_rules():
    from paddle_tpu_torch.distributed.sharding import megatron_rules
    return megatron_rules()


def bert_tp_cases(init, x, y, steps=3):
    """BERT at tensor-parallel degree 2 on a (1, 2) mesh: ``steps`` AdamW
    steps of ``build_train_step(sharding=...)`` on the batch ``(x, y)``
    (eval mode, p = 0) -> the losses, the dense parameters and moments
    after them, the collectives of one step; the TP model's forward at
    p = 0.1 against the dense model's from one dropout offset; an encoder
    layer with every dropout at 0.1 (its FFN's activation dropout too),
    forward and backward, against the dense layer."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.nn import TransformerEncoderLayer
    from paddle_tpu_torch.kernels.philox import DropoutState
    dist, rank, world = join_group((1, 2))
    feed = (tuple(torch.from_numpy(a) for a in x),
            tuple(torch.from_numpy(a) for a in y))
    out = {'rank': rank, 'model_rank': dist.get_rank('model'),
           'data_rank': dist.get_rank('data')}
    net = model(init).eval()
    cfg = dist.ShardingConfig(tensor_parallel_degree=2, fsdp=False,
                              param_rules=_tp_bert_rules())
    step = build_train_step(net=net, loss=net.pretraining_loss,
                            optimizer=topt.AdamW(learning_rate=LR,
                                                 weight_decay=0.01),
                            sharding=cfg, device='cpu')
    state = step.init_state()
    out['heads'] = net.bert.encoder.layers[0].self_attn.num_heads
    out['pieces'] = {k: tuple(p.shape) for k, p in step._tp.items()}
    losses = []
    for i in range(steps):
        dist.collective.reset_collective_counts()
        state, res = step(state, feed)
        losses.append(float(res.loss))
    out['counts_one_step'] = dist.collective.collective_counts()
    out['losses'] = losses
    out['params'] = numpy_tree(step.full_params(state))
    out['opt'] = numpy_tree(step.full_slots(state))
    # p = 0.1: the TP forward draws the dense model's masks
    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    dense = model(init, **drop).train()
    tp = model(init, **drop).train()
    dist.sharding.apply_tensor_parallel(tp, _tp_bert_rules())
    dist.parallel.mask_ranks(tp, True)
    with torch.no_grad():
        want = dense(*feed[0])[0].numpy()
        got = tp(*feed[0])[0].numpy()
    out['masked_forward'] = (got, want, tp.dropout_state.rank)
    # an encoder layer, every dropout (the FFN's activation too) at 0.1
    layers = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        layers.append(TransformerEncoderLayer(
            64, 4, 128, dropout=0.1, activation='gelu',
            dropout_state=DropoutState(77), device='cpu',
            generator=g).train())
    dist.sharding.apply_tensor_parallel(layers[1], _tp_bert_rules())
    src = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(4))
    res = []
    for layer in layers:
        x0 = src.clone().requires_grad_()
        o = layer(x0)
        gx, = torch.autograd.grad((o ** 2).sum(), [x0])
        res.append((o.detach().numpy(), gx.numpy()))
    out['layer_p01'] = res
    return out


class _TPBlock(torch.nn.Module):
    """The reference's ``tests/test_sharding_train.py`` ``_TPBlock``: a
    column-parallel (64 -> 128, ungathered) and a row-parallel (128 -> 8,
    parallel input) layer, from the dense weights ``w``."""

    def __init__(self, w):
        super().__init__()
        from paddle_tpu_torch.distributed import sharding as S
        self.col = S.ColumnParallelLinear.from_linear(
            _linear(w['col.weight'], w['col.bias']), gather_output=False)
        self.row = S.RowParallelLinear.from_linear(
            _linear(w['row.weight'], w['row.bias']), input_is_parallel=True)

    def forward(self, x):
        return self.row(self.col(x))


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _tp_block_step(dense_w, mesh):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.engine import build_train_step
    net = _TPBlock(dense_w)
    cfg = dist.ShardingConfig(fsdp=True, min_size=64,
                              tensor_parallel_degree=mesh[1])
    step = build_train_step(net=net, loss=_mse,
                            optimizer=topt.Adam(learning_rate=1e-2),
                            sharding=cfg, device='cpu')
    return net, step


def tp_fsdp_cases(dense_w, data, ckpt_dir):
    """TP with FSDP on a (2, 2) mesh (4 ranks): the reference's
    ``test_tensor_parallel_composes_with_fsdp_config`` case, each data
    rank on its half of each global batch -> losses, dense parameters,
    the pieces' layouts; then the step's state saved as a sharded
    checkpoint in ``ckpt_dir`` (each rank its pieces, rank 0 commits)."""
    from paddle_tpu_torch.resilience import CheckpointManager
    dist, rank, world = join_group((2, 2))
    net, step = _tp_block_step(dense_w, (2, 2))
    state = step.init_state()
    d, dr = dist.get_world_size('data'), dist.get_rank('data')
    losses = []
    for bx, by in data:
        n = bx.shape[0] // d
        feed = ((torch.from_numpy(bx[dr * n:(dr + 1) * n]),),
                (torch.from_numpy(by[dr * n:(dr + 1) * n]),))
        state, res = step(state, feed)
        losses.append(float(res.loss))
    out = {'rank': rank, 'losses': losses,
           'tp': {k: (p.tp_dim, tuple(p.shape)) for k, p in
                  step._tp.items()},
           'fsdp': sorted(step._shards.layout),
           'params': numpy_tree(step.full_params(state)),
           'opt': numpy_tree(step.full_slots(state))}
    CheckpointManager(ckpt_dir).save(state, step=3, sharding=step._shards)
    dist.collective.barrier()
    return out


def tp_restore_case(dense_w, ckpt_dir):
    """The (2, 2) checkpoint restored at (1, 2) by the same block's step,
    once the (2, 2) job (another spawn, running alongside) has committed
    it -> the dense parameters and moments it adopted."""
    from paddle_tpu_torch.resilience import CheckpointManager
    dist, rank, world = join_group((1, 2))
    manifest = os.path.join(ckpt_dir, 'ckpt_00000003', 'manifest.json')
    deadline = time.monotonic() + 180
    while not os.path.exists(manifest):     # the (2, 2) job commits it
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint at {manifest}")
        time.sleep(0.05)
    net, step = _tp_block_step(dense_w, (1, 2))
    state = step.init_state()
    loaded, meta = CheckpointManager(ckpt_dir).restore(
        sharding=step._shards)
    state = step.adopt_state(loaded)
    return {'params': numpy_tree(step.full_params(state)),
            'opt': numpy_tree(step.full_slots(state)),
            'pieces': {k: tuple(v.shape) for k, v in
                       state['params'].items()}}


def fleet_tp_case(init):
    """``fleet.init`` with ``strategy.tensor_parallel`` on a group of two
    ranks: the (1, 2) mesh it installs and the config; then
    ``hapi.Model.fit(strategy=)`` (SGD, 2 batches of 4) -> the dense
    parameters, and those of the same fit without the strategy."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet, sharding, strategy
    dist, rank, world = join_group()
    st = fleet.DistributedStrategy()
    st.tensor_parallel = True
    st.tensor_parallel_configs = {'tensor_parallel_degree': 2,
                                  'param_rules': _tp_bert_rules()}
    fleet.fleet.init(is_collective=True, strategy=st)
    cfg = strategy.current_config()
    out = {'axes': dict(dist.get_mesh().shape),
           'degree': cfg.tensor_parallel_degree,
           'model_rank': dist.get_rank('model')}
    items = samples(8)
    for key, strat in (('tp', st), ('dense', None)):
        net = model(init)
        m = pt.Model(net, device='cpu')
        m.prepare(topt.SGD(learning_rate=0.05,
                           parameters=net.named_parameters()),
                  net.pretraining_loss)
        m.fit(_loader(items, 4), epochs=1, strategy=strat, verbose=0)
        out[key] = numpy_tree(sharding.gather_tp(dict(
            net.named_parameters())))
    strategy.set_current_config(None)
    return out


def tp_rank_cases(col, row, emb, init, x, y, dense_w, ckpt_dir):
    """Every two-rank case of ``tests/test_torch_tensor_parallel.py``."""
    fleet = fleet_tp_case(init)
    layers = tp_layer_cases(col, row, emb)
    return {'layers': layers, 'bert': bert_tp_cases(init, x, y),
            'restore': tp_restore_case(dense_w, ckpt_dir), 'fleet': fleet}


# ring attention, ppermute, the pipeline, the sparse table (no JAX: the
# tests hold the results against the reference)

def _ring_world():
    from paddle_tpu_torch import distributed as dist
    torch.set_num_threads(1)
    world = int(os.environ.get('PADDLE_TRAINERS_NUM', '1'))
    dist.init_parallel_env((world,), ('seq',))
    return dist, dist.get_rank('seq'), world


def ring_cases(qkv, gpt=None):
    """Ring attention over a ``'seq'`` axis of every rank: the global form
    (forward, and q/k/v gradients of the squared output's sum) causal and
    not, the local form on this rank's blocks; ``ppermute``'s ring shift
    and a partial permutation (and its gradient); with ``gpt`` (``(config
    kwargs, weights, ids)``) a GPT's logits and parameter gradients with
    ``use_ring_attention``."""
    dist, rank, world = _ring_world()
    out = {'rank': rank}
    for causal in (True, False):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
        o = dist.ring_attention(q, k, v, causal=causal)
        out[f'global_{causal}'] = (o.detach().numpy(),
                                   *_grads_np((o ** 2).sum(), [q, k, v]))
        blocks = [torch.from_numpy(np.ascontiguousarray(
            np.split(a, world, axis=2)[rank])).requires_grad_()
            for a in qkv]
        o = dist.ring_attention(*blocks, causal=causal, local=True)
        out[f'local_{causal}'] = (o.detach().numpy(),
                                  *_grads_np((o ** 2).sum(), blocks))
    x = torch.tensor([float(rank), 10.0 + rank]).requires_grad_()
    ring = [(i, (i + 1) % world) for i in range(world)]
    shifted = dist.ppermute(x, ring, axis='seq')
    g, = torch.autograd.grad((shifted * (rank + 1)).sum(), [x])
    partial = dist.ppermute(x.detach(), [(0, world - 1), (1, 0)],
                            axis='seq')
    out['ppermute'] = (shifted.detach().numpy(), g.numpy(),
                       partial.numpy())
    out['counts'] = dist.collective.collective_counts()
    if gpt is not None:
        from paddle_tpu_torch.text.gpt import GPTConfig, GPTModel
        cfg, weights, ids = gpt
        net = GPTModel(GPTConfig(**cfg), device='cpu').eval()
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(torch.from_numpy(weights[name]))
        logits = net(torch.from_numpy(ids))
        names = [n for n, _ in net.named_parameters()]
        grads = torch.autograd.grad((logits ** 2).mean(),
                                    [p for _, p in net.named_parameters()])
        out['gpt'] = (logits.detach().numpy(),
                      {n: g.numpy() for n, g in zip(names, grads)})
    return out


def _mlp_stage(params, x):
    return torch.tanh(x @ params['w1'] + params['b1']) @ params['w2'] + \
        params['b2']


def pipeline_cases(per_stage, x, cases):
    """``pipeline_apply`` over a ``'pipe'`` axis of every rank, the
    reference's MLP stages (``tests/test_pipeline.py``): for each
    ``(n_micro, checkpoint)`` of ``cases`` the output, x's gradient and
    this stage's slice of each stacked parameter's gradient (loss: the sum
    of the squared output); the schedule; the stage-count error."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import pipeline as pp
    torch.set_num_threads(1)
    world = int(os.environ.get('PADDLE_TRAINERS_NUM', '1'))
    dist.init_parallel_env((world,), ('pipe',))
    s = dist.get_rank('pipe')
    out = {'rank': s}
    for n_micro, ckpt in cases:
        stacked = {k: v.requires_grad_() for k, v in pp.stack_stage_params(
            [{k: torch.from_numpy(v) for k, v in p.items()}
             for p in per_stage]).items()}
        xt = torch.from_numpy(x).requires_grad_()
        y = pp.pipeline_apply(_mlp_stage, stacked, xt, n_micro,
                              checkpoint=ckpt)
        grads = _grads_np((y ** 2).sum(), [xt] + list(stacked.values()))
        out[(n_micro, ckpt)] = (y.detach().numpy(), grads[0], {
            k: g[s] for k, g in zip(stacked, grads[1:])})
    out['schedule'] = pp.schedule(world, cases[0][0])
    # one stage more than the axis has ranks
    extra = pp.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in per_stage[0].items()}] *
        (world + 1))
    try:
        pp.pipeline_apply(_mlp_stage, extra, torch.from_numpy(x), 2)
        out['mismatch'] = None
    except ValueError as e:
        out['mismatch'] = str(e)
    return out


def table_cases(weight, ids, grads, lr):
    """``SparseShardedTable`` over a ``'model'`` axis of every rank: the
    whole table after ``set_state_dict(weight)``, ``pull(ids)`` and its
    gradient (of the pulled rows' sum) on this rank's block, then
    ``push(ids, grads, lr)`` -> the whole table."""
    from paddle_tpu_torch import distributed as dist
    torch.set_num_threads(1)
    world = int(os.environ.get('PADDLE_TRAINERS_NUM', '1'))
    dist.init_parallel_env((1, world))
    t = dist.SparseShardedTable(*weight.shape, device='cpu',
                                generator=torch.Generator().manual_seed(0))
    t.set_state_dict({'weight': weight})
    rows = t.pull(torch.from_numpy(ids))
    g, = torch.autograd.grad(rows.sum(), [t.weight])
    t.push(torch.from_numpy(ids), torch.from_numpy(grads), lr=lr)
    return {'rank': dist.get_rank('model'), 'rows': rows.detach().numpy(),
            'grad': g.numpy(), 'lo': t.lo,
            'after': t.state_dict()['weight'].numpy()}


def bn_net(init=None):
    """A conv + BatchNorm net (the reference's layout and names), on
    ``init`` (reference names)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.interop import load_paddle_tpu_state
    net = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1, device='cpu'),
                        nn.BatchNorm2D(4, device='cpu'), nn.ReLU(),
                        nn.Flatten(), nn.Linear(4 * 5 * 5, 3, device='cpu'))
    if init is not None:
        load_paddle_tpu_state(net, init)
    return net


def bn_cases(init, data, lr):
    """A conv + BatchNorm net stepped (SGD) on this rank's slice of each
    global batch by the DataParallel step and by the FSDP step: the losses
    and the net's state (reference names) after the steps. Both take
    BatchNorm's statistics over the global batch. Also a ``SyncBatchNorm``
    forward in training on this rank's rows of the first batch: its
    output and running statistics."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.engine import build_train_step
    from paddle_tpu_torch.interop import to_paddle_tpu_state
    dist, rank, world = join_group()
    out = {}
    for kind in ('dp', 'fsdp'):
        net = bn_net(init)
        target = dist.DataParallel(net) if kind == 'dp' else net
        step = build_train_step(
            net=target, loss=nn.CrossEntropyLoss(),
            optimizer=topt.SGD(learning_rate=lr),
            sharding=dist.ShardingConfig(min_size=1) if kind == 'fsdp'
            else None, device='cpu')
        state = step.init_state()
        losses = []
        for x, y in data:
            n = len(x) // world
            sl = slice(rank * n, (rank + 1) * n)
            state, res = step(state, ((torch.from_numpy(x[sl]),),
                                      (torch.from_numpy(y[sl]),)))
            losses.append(float(res.loss))
        step.write_back(state)
        out[kind] = (losses, to_paddle_tpu_state(net))
    # SyncBatchNorm's forward on this rank's rows, in training
    sbn = nn.SyncBatchNorm(3, device='cpu')
    x = data[0][0]
    n = len(x) // world
    y = sbn(torch.from_numpy(x[rank * n:(rank + 1) * n]))
    out['sync_bn'] = (y.detach().numpy(), sbn._mean.numpy().copy(),
                      sbn._variance.numpy().copy())
    return out
