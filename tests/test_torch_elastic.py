"""The elastic downsize of the port's supervisor (``distributed.spawn(
elastic=True)``) against the reference's soak
(``tests/test_elastic_checkpoint.py::TestElasticSupervisor``): four gloo
ranks train through ``engine.fit(world=, rank=)``, rank 1 is killed by
``faultinject.kill_rank_at_step`` at a batch (a marker file, never a
sleep: the reference's soak depends on timing, this one does not), and
the job finishes on three ranks resumed from the checkpoint the four
wrote. The soak's ranks train on the same batches and synchronise
nothing (each rank writes its checkpoint piece, rank 0 commits), so the
survivors equal each other and an uninterrupted one-process run bit for
bit (one CPU thread each). The spawn joins with a 60 s timeout.
"""
import os

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.resilience import CheckpointManager

import _torch_dist_ranks as R
from _torch_spines import clean_spines  # noqa: F401  (autouse)

JOIN_S = 60


def test_elastic_downsize_4_to_3_bitwise(tmp_path, monkeypatch):
    """Four ranks, rank 1 killed at batch 9 (epoch 2): the job finishes on
    three after one downsize, resumed from the epoch-1 checkpoint the four
    wrote; the survivors equal each other and the uninterrupted run bit
    for bit; the ranks' telemetry flushers are merged by the supervisor
    (``observability.aggregate``)."""
    tel = tmp_path / 'telemetry'
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY', '1')
    monkeypatch.setenv('PADDLE_TPU_TELEMETRY_RUN_DIR', str(tel))
    t_obs.enable()
    ckpt, marker = str(tmp_path / 'ckpts'), str(tmp_path / 'killed')
    ctx = dist.spawn(R.soak_rank, (ckpt, marker), nprocs=4, backend='gloo',
                     join=False, elastic=True, max_restarts=1)
    results = ctx.join(timeout=JOIN_S)
    sup = ctx._supervisor
    assert os.path.exists(marker) and sup.downsizes == 1
    assert [r[:3] for r in results] == [(r, 3, 1) for r in range(3)]
    assert {r[4] for r in results} == {6}       # the epoch-1 checkpoint
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        monkeypatch.delenv('PADDLE_TPU_TELEMETRY_RUN_DIR')
        ref = R.soak_rank(str(tmp_path / 'ref'), str(tmp_path / 'none'))
    finally:
        torch.set_num_threads(prev)
    for r in results:
        for k, v in ref[3].items():
            assert np.array_equal(r[3][k], v), (r[0], k)
    # the checkpoint the three resumed from was written by four ranks
    assert CheckpointManager(ckpt).load_manifest(6)['world'] == 4
    assert (tel / 'cluster_snapshot.json').exists()
    assert (tel / 'merged_events.jsonl').exists()
    snap = t_obs.snapshot()
    assert snap['counters']['distributed.elastic_downsizes'] == 1
    assert snap['histograms']['elastic.recovery_ms']['count'] == 1
    evs = [e['ev'] for e in t_obs.event_log()
           if str(e.get('ev', '')).startswith('elastic.')]
    assert {'elastic.rank_death', 'elastic.downsize',
            'elastic.relaunch'} <= set(evs)
