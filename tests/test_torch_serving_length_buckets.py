"""Length buckets for one-shot serving: ``register(layer=...,
bucket_spec=BucketSpec(batch_buckets, length_buckets))`` takes sequence
inputs of any length up to the example's, pads each batch to the length
bucket of its longest request, and warms every (batch, length) pair.

On the CPU, at vocab 30 and 5 tags:

- a tagger whose BiGRU is given the lengths (``nn.GRU(direction=
  'bidirect')`` with ``sequence_length``) reads none of its padding, so
  each response's prefix equals the model run alone on the unpadded
  request, whatever it was batched with;
- ``text.SequenceTagging`` (LAC's) gives its encoder no lengths, as the
  reference does, so its reverse GRU starts in the padding and its tags
  depend on how far a request is padded: it is served with the one length
  bucket it is trained at, and then each response equals the tagger run
  alone on its request padded to that length.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn, text
from paddle_tpu_torch.serving import BucketSpec, ServingEngine

LONGEST = 8
GROUPS = [((3, 2), 4), ((3, 7, 1), 8), ((4,), 4)]


class _LengthAwareTagger(torch.nn.Module):
    def __init__(self, generator):
        super().__init__()
        kw = dict(device='cpu', generator=generator)
        self.embed = nn.Embedding(30, 6, **kw)
        self.gru = nn.GRU(6, 4, direction='bidirect', **kw)
        self.fc = nn.Linear(8, 5, **kw)

    def forward(self, word, lengths):
        out, _ = self.gru(self.embed(word), sequence_length=lengths)
        tags = self.fc(out).argmax(-1)
        keep = torch.arange(word.shape[1])[None] < lengths[:, None]
        return torch.where(keep, tags, 0)


def _engine(layer, length_buckets):
    eng = ServingEngine(device='cpu')
    ep = eng.register('tagger', layer=layer, example={
        'word': np.zeros(LONGEST, np.int64), 'lengths': np.int64(LONGEST)},
        bucket_spec=BucketSpec((1, 4), length_buckets))
    return layer, eng, ep


@pytest.fixture(scope='module')
def served():
    return _engine(_LengthAwareTagger(torch.Generator().manual_seed(3)),
                   (4, LONGEST))


@pytest.fixture(scope='module')
def lac():
    return _engine(text.SequenceTagging(
        30, 5, 6, 4, device='cpu',
        generator=torch.Generator().manual_seed(3)), (LONGEST,))


def _request(rs, n):
    return {'word': rs.randint(1, 30, n).astype(np.int64),
            'lengths': np.int64(n)}


def _alone(model, req, padded_to):
    word = np.zeros(padded_to, np.int64)
    word[:len(req['word'])] = req['word']
    with torch.no_grad():
        return model(torch.from_numpy(word[None]),
                     torch.tensor([int(req['lengths'])]))[0].numpy()


def _serve(eng, ep, reqs):
    futs = [ep.submit(r) for r in reqs]
    eng.run_until_idle()
    outs = []
    for fut in futs:
        resp = fut.result(timeout=60)
        assert resp.ok
        outs.append(np.asarray(resp.outputs))
    return outs


def test_warmup_runs_every_batch_and_length_bucket(served):
    _, eng, _ = served
    assert eng.warmup()['tagger'] == 4


@pytest.mark.parametrize('lengths,bucket', GROUPS)
def test_a_batch_pads_to_its_longest_requests_bucket(served, lengths,
                                                     bucket):
    model, eng, ep = served
    rs = np.random.RandomState(sum(lengths))
    reqs = [_request(rs, n) for n in lengths]
    for req, out in zip(reqs, _serve(eng, ep, reqs)):
        n = len(req['word'])
        assert out.shape == (bucket,)
        np.testing.assert_array_equal(out[:n], _alone(model, req, n))
        assert not out[n:].any()


def test_the_lac_tagger_reads_its_padding(lac):
    """Why LAC is served at one length: its emissions over a request's own
    words change with the padding after them."""
    tagger = lac[0]
    rs = np.random.RandomState(5)
    word = rs.randint(1, 30, 3)
    emissions = []
    for padded_to in (4, LONGEST):
        seen = []
        hook = tagger.fc.register_forward_hook(
            lambda m, a, out: seen.append(out[0, :3].detach().clone()))
        _alone(tagger, {'word': word, 'lengths': 3}, padded_to)
        hook.remove()
        emissions.append(seen[0])
    assert not torch.allclose(emissions[0], emissions[1], atol=1e-6)


@pytest.mark.parametrize('lengths,bucket', GROUPS)
def test_a_tagger_served_at_one_length_answers_as_alone(lac, lengths,
                                                        bucket):
    tagger, eng, ep = lac
    rs = np.random.RandomState(sum(lengths))
    reqs = [_request(rs, n) for n in lengths]
    for req, out in zip(reqs, _serve(eng, ep, reqs)):
        assert out.shape == (LONGEST,)
        np.testing.assert_array_equal(out, _alone(tagger, req, LONGEST))
        assert not out[len(req['word']):].any()


def test_a_request_longer_than_the_largest_bucket_is_refused(served):
    _, _, ep = served
    rs = np.random.RandomState(1)
    with pytest.raises(ValueError, match='registered example'):
        ep.submit(_request(rs, LONGEST + 1))
    with pytest.raises(ValueError, match='registered example'):
        ep.submit({'word': np.zeros(3, np.int32), 'lengths': np.int64(3)})


def test_an_example_shorter_than_the_largest_bucket_is_refused():
    eng = ServingEngine(device='cpu')
    with pytest.raises(ValueError, match='largest length bucket'):
        eng.register('m', predict_fn=lambda feeds: feeds['x'],
                     example={'x': np.zeros(4, np.float32)},
                     bucket_spec=BucketSpec((1,), (4, 8)))
