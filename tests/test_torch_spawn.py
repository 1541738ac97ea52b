"""The port's launcher (``distributed.spawn`` / ``launch``) and its
supervisor: results in rank order, ``faultinject.boot_fail`` within and
without ``max_restarts``, a rank's death as ``RankFailedError`` (its
signal and the tail of its log), and a script run once a rank by
``python -m paddle_tpu_torch.distributed.launch``, against the reference's
contract (``tests/test_elastic_checkpoint.py``). The elastic downsize is
``tests/test_torch_elastic.py``'s (a file of its own: each spawned rank
pays a fresh interpreter's torch import, and a file stays near 20 s).

Every spawn joins with a timeout (at most 60 s) and kills its tree on
expiry; the ranks run gloo on the CPU.
"""
import os
import subprocess
import sys

import pytest

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.resilience import faultinject as fi

import _torch_dist_ranks as R
from _torch_spines import clean_spines  # noqa: F401  (autouse)

JOIN_S = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_spawn_results_in_rank_order_and_boot_restart():
    """Three ranks, rank 1 crashing once before its started marker
    (``boot_fail``) and restarted within ``max_restarts``: the results come
    back in rank order, and a second join sees the same."""
    with fi.boot_fail(1, times=1):
        ctx = dist.spawn(R.hello, nprocs=3, backend='gloo', join=False,
                         max_restarts=1)
        want = [(r, 3, 6.0, 'gloo') for r in range(3)]
        assert ctx.join(timeout=JOIN_S) == want
    assert ctx.join() == want
    assert ctx._supervisor.restarts_used == 1


def test_rank_death_raises_with_signal_and_log_tail():
    ctx = dist.spawn(R.die_on_rank1, nprocs=2, backend='gloo', join=False)
    with pytest.raises(dist.RankFailedError) as e:
        ctx.join(timeout=JOIN_S)
    err = e.value
    assert err.rank == 1 and err.signal_name == 'SIGKILL'
    assert 'rank-1-last-words' in err.log_tail
    assert all(not p.is_alive() for p in ctx.processes)


def test_boot_fail_without_restarts_fails_fast():
    with fi.boot_fail(0, times=1):
        ctx = dist.spawn(R.hello, nprocs=2, backend='gloo', join=False)
        with pytest.raises(dist.RankFailedError) as e:
            ctx.join(timeout=JOIN_S)
    assert e.value.rank == 0 and e.value.exitcode == 43
    assert 'no heartbeat ever written' in str(e.value)


def test_launch_runs_a_script_per_rank(tmp_path):
    script = tmp_path / 'train.py'
    script.write_text(
        "import sys, torch\n"
        "from paddle_tpu_torch import distributed as dist\n"
        "dist.init_parallel_env(backend='gloo')\n"
        "t = torch.tensor([dist.get_rank() + 1.0])\n"
        "dist.all_reduce(t)\n"
        "open(sys.argv[1] + str(dist.get_rank()), 'w').write(\n"
        "    f'{dist.get_world_size()} {float(t)}')\n")
    env = dict(os.environ)
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'PADDLE_TRAINER_ENDPOINTS'):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch',
         '--nproc_per_node', '2', '--log_dir', str(tmp_path / 'logs'),
         str(script), str(tmp_path / 'out_')],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=JOIN_S)
    assert out.returncode == 0, out.stderr
    for r in range(2):
        assert (tmp_path / f'out_{r}').read_text() == '2 3.0'
