"""``optimizer.FlatFusedUpdate`` against the JAX package's, and the flat
bf16 train step (``bench.py::bench_bert``'s flat mode) against the
per-parameter bf16 recipe.

- The update: Adam and AdamW, with and without ``decay_mask`` (and Adam
  with a coupled L2 ``weight_decay``), three steps on the same parameters
  and gradients through both packages' ``FlatFusedUpdate``; the
  unflattened parameters and moments within 1e-6 of each tensor's largest
  entry (fp32; the two order a few roundings differently), the one
  ``beta*_pow`` pair within 1e-7.
- The layout: segments start at multiples of 128 elements, the gaps are
  zeros and stay zeros, and ``unflatten`` returns views of the buffer.
- The flat step: a 2-layer narrow ``BertForPretraining`` (p = 0) stepped
  three times through ``build_train_step(optimizer=FlatFusedUpdate(...,
  compute_dtype=bf16))`` and through the per-parameter bf16 recipe on the
  same weights and batch: the same parameters and moments, bit for bit (a
  cast is elementwise, and the update is the same elementwise ops on one
  buffer); its parameters are views of the master.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import FlatFusedUpdate as JaxFlat

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.engine import build_train_step
from paddle_tpu_torch.optimizer import FlatFusedUpdate
from paddle_tpu_torch.optimizer.fused import ALIGN
from paddle_tpu_torch.text.bert import BertConfig, BertForPretraining

SHAPES = {'enc.w': (7, 33), 'enc.b': (33,), 'head.w': (33, 5),
          'head.b': (5,), 'scale': ()}
REL = 1e-6


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {k: np.asarray(rs.randn(*s), np.float32)
            for k, s in SHAPES.items()}


def _mask(name):
    return name.endswith('.w')


OPTS = {
    'adam': (lambda m: jopt.Adam(learning_rate=0.01),
             lambda: topt.Adam(learning_rate=0.01)),
    'adam_l2': (lambda m: jopt.Adam(learning_rate=0.01, weight_decay=0.05),
                lambda: topt.Adam(learning_rate=0.01, weight_decay=0.05)),
    'adamw': (lambda m: jopt.AdamW(learning_rate=0.01, weight_decay=0.1),
              lambda: topt.AdamW(learning_rate=0.01, weight_decay=0.1)),
}


@pytest.mark.parametrize("kind,masked", [('adam', False), ('adam_l2', False),
                                         ('adamw', False), ('adamw', True)])
def test_flat_update_matches_reference(kind, masked):
    params = _tree(0)
    grads = [_tree(s) for s in (1, 2, 3)]
    make_ref, make_port = OPTS[kind]
    ref = JaxFlat(make_ref(masked), {k: jnp.asarray(v)
                                     for k, v in params.items()},
                  decay_mask=_mask if masked else None)
    port = FlatFusedUpdate(make_port(), {k: torch.from_numpy(v)
                                         for k, v in params.items()},
                           decay_mask=_mask if masked else None)
    rp = ref.flatten({k: jnp.asarray(v) for k, v in params.items()})
    rst = ref.init_state(rp)
    tp = port.flatten({k: torch.from_numpy(v) for k, v in params.items()})
    tst = port.init_state(tp)
    for g in grads:
        rp, rst = ref.update(rp, {k: jnp.asarray(v) for k, v in g.items()},
                             rst)
        out = port.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          tst)
        assert out[0] is tp and out[1] is tst
    for slot_r, slot_t in ((rp, tp), (rst['moment1'], tst['moment1']),
                           (rst['moment2'], tst['moment2'])):
        want = {k: np.asarray(v) for k, v in ref.unflatten(slot_r).items()}
        got = port.unflatten(slot_t)
        for k in SHAPES:
            err = np.abs(got[k].numpy() - want[k]).max()
            assert err <= REL * np.abs(want[k]).max() + 1e-12, (k, err)
    for s in ('beta1_pow', 'beta2_pow'):
        assert tst[s].dim() == 0 and tst[s].dtype == torch.float32
        assert abs(float(tst[s]) - float(rst[s])) <= 1e-7
    # the gaps between the segments stay zero
    used = torch.zeros(port.numel, dtype=torch.bool)
    for k in SHAPES:
        o = port.offsets[k]
        used[o:o + port.sizes[k]] = True
    assert not tp[~used].any() and not tst['moment2'][~used].any()


def test_layout_is_aligned_views():
    params = {k: torch.from_numpy(v) for k, v in _tree(5).items()}
    flat = FlatFusedUpdate(topt.AdamW(), params)
    assert flat.names == sorted(SHAPES)
    assert all(o % ALIGN == 0 for o in flat.offsets.values())
    buf = flat.flatten(params)
    assert buf.numel() == flat.numel and buf.dtype == torch.float32
    views = flat.unflatten(buf)
    for k, v in views.items():
        assert v.shape == params[k].shape and torch.equal(v, params[k])
        assert v._base is buf              # a view, not a copy
    views['head.b'][0] = 42.0
    assert float(buf[flat.offsets['head.b']]) == 42.0
    # bind: the parameters become views of the buffer
    leaves = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    flat.bind(leaves, buf)
    assert float(leaves['head.b'].detach()[0]) == 42.0
    with pytest.raises(ValueError, match='decay_mask'):
        FlatFusedUpdate(topt.Adam(), params, decay_mask=_mask)


SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128)
BF = torch.bfloat16


def _batch(seed=0, b=2, seq=64):
    rs = np.random.RandomState(seed)
    k = seq * 15 // 100
    x = {'input_ids': torch.from_numpy(rs.randint(0, 512, (b, seq))),
         'token_type_ids': torch.zeros(b, seq, dtype=torch.int64),
         'masked_positions': torch.from_numpy(np.stack(
             [rs.choice(seq, k, replace=False) for _ in range(b)]))}
    y = (torch.from_numpy(rs.randint(0, 512, (b, k))),
         torch.from_numpy(rs.randint(0, 2, (b, 1))))
    return x, y


def _recipe(net, cast):
    """``bench_bert``'s loss: the model on (cast) parameters through
    ``functional_call``, the loss on fp32 logits."""
    def loss_fn(params, batch):
        x, y = batch
        if cast:
            params = {k: v.to(BF) for k, v in params.items()}
        logits, nsp = torch.func.functional_call(net, params, (), x)
        return net.pretraining_loss(logits.float(), nsp.float(), *y), \
            (logits, nsp)
    return loss_fn


def test_flat_bf16_step_is_the_per_parameter_recipe_bit_for_bit():
    def model():
        return BertForPretraining(
            BertConfig(**SMALL), device='cpu',
            generator=torch.Generator().manual_seed(9)).eval()
    batch = _batch()
    per, flat_net = model(), model()
    p_step = build_train_step(_recipe(per, True), topt.AdamW(1e-3),
                              params=dict(per.named_parameters()),
                              device='cpu')
    flat = FlatFusedUpdate(topt.AdamW(1e-3),
                           dict(flat_net.named_parameters()),
                           compute_dtype=BF)
    f_step = build_train_step(_recipe(flat_net, False), flat,
                              params=dict(flat_net.named_parameters()),
                              device='cpu')
    ps, fs = p_step.init_state(), f_step.init_state()
    for _ in range(3):
        ps, pr = p_step(ps, batch)
        fs, fr = f_step(fs, batch)
        assert float(pr.loss) == float(fr.loss)
        assert fr.outputs[0].dtype == BF
    m1, m2 = flat.unflatten(fs['opt']['moment1']), \
        flat.unflatten(fs['opt']['moment2'])
    for k, p in per.named_parameters():
        q = dict(flat_net.named_parameters())[k]
        assert q.data_ptr() == fs['params'][flat.offsets[k]:].data_ptr()
        assert torch.equal(p.detach(), q.detach()), k
        assert torch.equal(ps['opt'][k]['moment1'], m1[k]), k
        assert torch.equal(ps['opt'][k]['moment2'], m2[k]), k
    assert torch.equal(ps['opt'][k]['beta2_pow'], fs['opt']['beta2_pow'])
