"""``paddle_tpu_torch.metric`` against ``paddle_tpu.metric`` on the same
numpy inputs: ``Accuracy`` (its correctness matrix, hit totals and counts,
top-1 and top-k, class-id / (N, 1) / one-hot labels), ``Precision``,
``Recall``, ``Auc``, the functional ``accuracy`` and the fluid extras
(``edit_distance``, ``chunk_eval``, ``auc``, ``detection_map`` and their
accumulators, ``CompositeMetric``), at 1e-12. Scores come from
``randn``, so top-k has no ties (``torch.topk`` and the reference's
``argsort`` may order tied scores differently).

The reference's accuracy is float32: NumPy 2 keeps its float32 hit sums
float32 when added to Python floats. The port counts in float64, so its
``accumulate`` is held at 1e-12 to the reference's own totals over its
counts, and to the reference's float32 quotient within float32's
rounding. One reference fault is recorded: on (batch, positions,
classes) predictions its ``update`` counts only the batch dimension, so
the accuracy can pass 1 (ROADMAP.md, Queue 3)."""
import numpy as np
import pytest
import torch

from paddle_tpu import metric as jmetric

from paddle_tpu_torch import metric as tmetric

F32_EPS = float(np.finfo(np.float32).eps)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, 'numpy') else x)


def _scores(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _accuracy_pair(topk, batches):
    got, want = tmetric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    for pred, label in batches:
        c_got = got.compute(torch.from_numpy(pred), torch.from_numpy(label))
        c_want = want.compute(pred, label)
        assert isinstance(c_got, torch.Tensor)
        np.testing.assert_array_equal(c_got.numpy(), _np(c_want))
        step = got.update(c_got)
        want_step = want.update(c_want)
        assert isinstance(step, torch.Tensor) and step.dim() == 0
        # the running top-1 hits (the counts differ on rank-3 predictions)
        assert float(step) * got.count[0] == pytest.approx(
            float(want_step) * want.count[0], rel=F32_EPS)
    return got, want


@pytest.mark.parametrize('topk', [(1,), (1, 5), (2, 3)])
@pytest.mark.parametrize('labels', ['ids', 'column', 'one_hot'])
def test_accuracy_matches_reference(topk, labels):
    batches = []
    for i in range(3):
        pred = _scores((6, 10), seed=i)
        ids = np.random.RandomState(10 + i).randint(0, 10, 6)
        # a few rows right at rank 1, so every k has hits
        ids[:2] = pred[:2].argmax(-1)
        label = {'ids': ids.astype(np.int64),
                 'column': ids[:, None].astype(np.int64),
                 'one_hot': np.eye(10, dtype=np.float32)[ids]}[labels]
        batches.append((pred, label))
    got, want = _accuracy_pair(topk, batches)
    assert got.count == want.count == [18] * len(topk)
    assert got.total == [float(t) for t in want.total]
    exact = [float(t) / c for t, c in zip(want.total, want.count)]
    acc = got.accumulate()
    acc = acc if isinstance(acc, list) else [acc]
    ref = want.accumulate()
    ref = ref if isinstance(ref, list) else [ref]
    np.testing.assert_allclose(acc, exact, rtol=1e-12, atol=0)
    np.testing.assert_allclose(acc, np.asarray(ref, np.float64),
                               rtol=F32_EPS, atol=0)
    assert got.name() == want.name()
    got.reset()
    assert got.total == [0.] * len(topk) and got.count == [0] * len(topk)


def test_reference_fault_accuracy_counts_only_the_batch_dimension():
    """(2, 3, 10) predictions, every position right: the reference counts
    2 (``c.shape[0]``, ``paddle_tpu/metric/__init__.py:62``) against 6
    hits and reports 3.0; the port counts the 6 positions."""
    pred = _scores((2, 3, 10))
    label = pred.argmax(-1).astype(np.int64)
    got, want = _accuracy_pair((1,), [(pred, label)])
    assert float(want.accumulate()) == 3.0
    assert want.count == [2] and float(want.total[0]) == 6.0
    assert got.accumulate() == 1.0
    assert got.count == [6] and got.total == [6.0]
    # on rank-2 predictions both count the rows
    flat, _ = _accuracy_pair((1,), [(pred.reshape(6, 10),
                                     label.reshape(6))])
    assert flat.accumulate() == 1.0


def test_accuracy_mlm_shape_stays_small():
    """The MLM head's (batch, positions, vocab) logits: ``compute`` hands
    back (batch, positions, maxk), on the logits' device."""
    pred = torch.from_numpy(_scores((2, 7, 50)))
    label = torch.from_numpy(np.random.RandomState(1).randint(0, 50, (2, 7)))
    acc = tmetric.Accuracy(topk=(1, 5))
    c = acc.compute(pred.requires_grad_(), label)
    assert c.shape == (2, 7, 5) and c.device == pred.device
    assert not c.requires_grad
    acc.update(c)
    assert acc.count == [14, 14]


@pytest.mark.parametrize('cls', ['Precision', 'Recall', 'Auc'])
def test_binary_metrics_match_reference(cls):
    got, want = getattr(tmetric, cls)(), getattr(jmetric, cls)()
    rs = np.random.RandomState(3)
    for i in range(4):
        preds = rs.rand(20, 2 if (cls == 'Auc' and i % 2) else 1) \
            .astype(np.float32)
        labels = rs.randint(0, 2, (20, 1)).astype(np.int64)
        got.update(torch.from_numpy(preds) if i % 2 else preds,
                   torch.from_numpy(labels) if i % 2 else labels)
        want.update(preds, labels)
    np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                               rtol=1e-12, atol=0)
    assert got.name() == want.name()
    got.reset()
    assert got.accumulate() == 0.0


@pytest.mark.parametrize('k', [1, 3])
def test_functional_accuracy_matches_reference(k):
    pred = _scores((12, 8), seed=4)
    label = np.random.RandomState(5).randint(0, 8, (12, 1)).astype(np.int64)
    got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                           k=k)
    want = jmetric.accuracy(pred, label, k=k)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(_np(want)), rtol=1e-12,
                               atol=0)


def test_edit_distance_matches_reference():
    rs = np.random.RandomState(6)
    hyp = rs.randint(0, 5, (4, 7)).astype(np.int64)
    ref = rs.randint(0, 5, (4, 6)).astype(np.int64)
    hl = np.array([7, 3, 0, 5])
    rl = np.array([6, 6, 2, 0])
    for kw in (dict(), dict(normalized=False),
               dict(ignored_tokens=[0], input_length=hl, label_length=rl)):
        got = tmetric.edit_distance(torch.from_numpy(hyp), ref, **kw)
        want = jmetric.edit_distance(hyp, ref, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=0)
        em, jm = tmetric.EditDistance(), jmetric.EditDistance()
        em.update(got[0], int(got[1][0]))
        jm.update(_np(want[0]), int(_np(want[1])[0]))
        np.testing.assert_allclose(em.accumulate(), jm.accumulate(),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize('scheme,types', [('IOB', 3), ('IOE', 2),
                                          ('IOBES', 2), ('plain', 4)])
def test_chunk_eval_matches_reference(scheme, types):
    rs = np.random.RandomState(7)
    n_tags = {'IOB': 2, 'IOE': 2, 'IOBES': 4, 'plain': 1}[scheme] * types + 1
    inf = rs.randint(0, n_tags, (3, 12)).astype(np.int64)
    lab = inf.copy()
    lab[:, ::3] = rs.randint(0, n_tags, (3, 4))
    lens = np.array([12, 7, 9])
    for kw in (dict(), dict(seq_length=lens, excluded_chunk_types=[0])):
        got = tmetric.chunk_eval(inf, torch.from_numpy(lab), scheme, types,
                                 **kw)
        want = jmetric.chunk_eval(inf, lab, scheme, types, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=0)
        ce, jc = tmetric.ChunkEvaluator(), jmetric.ChunkEvaluator()
        ce.update(*got[3:])
        jc.update(*[_np(v) for v in want[3:]])
        np.testing.assert_allclose(ce.accumulate(), jc.accumulate(),
                                   rtol=1e-12, atol=0)


def test_functional_auc_matches_reference():
    rs = np.random.RandomState(8)
    scores = rs.rand(40, 2).astype(np.float32)
    labels = rs.randint(0, 2, (40, 1))
    for x in (scores, scores[:, 1]):
        got = tmetric.auc(torch.from_numpy(np.ascontiguousarray(x)), labels)
        np.testing.assert_allclose(_np(got), _np(jmetric.auc(x, labels)),
                                   rtol=1e-12, atol=0)
    with pytest.raises(NotImplementedError):
        tmetric.auc(scores, labels, curve='PR')


def _detections(rs, n_img, class_num):
    dets, labs, boxes = [], [], []
    for _ in range(n_img):
        m = rs.randint(1, 4)
        xy = rs.rand(m, 2) * 10
        gt = np.concatenate([xy, xy + 2 + rs.rand(m, 2) * 3], 1)
        gl = rs.randint(0, class_num, m)
        k = rs.randint(1, 6)
        pick = rs.randint(0, m, k)
        jitter = rs.randn(k, 4) * 0.6
        d = np.concatenate([gl[pick, None].astype(np.float64),
                            rs.rand(k, 1), gt[pick] + jitter], 1)
        d[rs.rand(k) < 0.2, 0] = -1       # padding rows
        dets.append(d.astype(np.float32))
        labs.append(gl)
        boxes.append(gt.astype(np.float32))
    return dets, labs, boxes


@pytest.mark.parametrize('ap_version', ['integral', '11point'])
def test_detection_map_matches_reference(ap_version):
    rs = np.random.RandomState(9)
    dets, labs, boxes = _detections(rs, 5, 3)
    got = tmetric.detection_map([torch.from_numpy(d) for d in dets], labs,
                                boxes, 3, ap_version=ap_version)
    want = jmetric.detection_map(dets, labs, boxes, 3, ap_version=ap_version)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=0)
    dm = tmetric.DetectionMAP(3, ap_version=ap_version)
    jm = jmetric.DetectionMAP(3, ap_version=ap_version)
    for i in (0, 3):
        dm.update(dets[i:i + 3], labs[i:i + 3], boxes[i:i + 3])
        jm.update(dets[i:i + 3], labs[i:i + 3], boxes[i:i + 3])
    np.testing.assert_allclose(dm.accumulate(), jm.accumulate(),
                               rtol=1e-12, atol=0)
    with pytest.raises(NotImplementedError):
        tmetric.detection_map(dets, labs, boxes, 3, evaluate_difficult=False)


def test_composite_metric_matches_reference():
    got, want = tmetric.CompositeMetric(), jmetric.CompositeMetric()
    for m, cls in ((got, tmetric), (want, jmetric)):
        m.add_metric(cls.Precision())
        m.add_metric(cls.Recall())
    rs = np.random.RandomState(2)
    preds, labels = rs.rand(30).astype(np.float32), rs.randint(0, 2, 30)
    got.update(torch.from_numpy(preds), labels)
    want.update(preds, labels)
    np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                               rtol=1e-12, atol=0)
    got.reset()
    assert got.accumulate() == [0.0, 0.0]


def test_module_surface():
    from paddle_tpu_torch.metric import metrics
    assert metrics.Accuracy is tmetric.Accuracy
    for name in tmetric.__all__:
        assert hasattr(tmetric, name), name
    assert set(metrics.__all__) == set(jmetric.metrics.__all__)
