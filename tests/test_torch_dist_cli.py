"""The port's training CLI over two gloo ranks on the CPU (`--coordinator
--num-processes --process-id --dist-backend gloo`, or `--devices 2`),
at the tiny model of `test_torch_cli.py` on a fake ZJU fixture of 3
frames and views 1 and 7 (`test_torch_dist_cli_eval.py` runs the
validation and test CLIs so). The ranks run in `tests/torch_mp_worker.py`,
which seeds each dataset item's draws by its index, so that a rank draws
the items a single process would (the datasets otherwise draw from one
generator in the order the prefetch threads ask).

- `cli.train`, one epoch of 3 steps: two ranks equal one process over
  the same global batches (each frame's 2 views, a view a rank). The
  step-0 losses in `metrics.tsv` agree to its 6 digits; the parameters
  after the epoch agree to 1e-6 but at under 1 in 1,000 elements (an
  Adam update flips with the sign of a roundoff-level gradient, by at
  most 2 lr a step). `metrics.tsv` and the checkpoint are written once
  (rank 0). `--devices 2 --exit-after 0` stops both ranks after one step
  with exit code 2, and a rank that fails makes it exit 1.
- The placement rule: NCCL with two ranks on one device raises, as does
  NCCL on the CPU and CUDA without a GPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_cli import tiny_config
from test_torch_ddp import WORKER, _free_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    from arah_tpu_torch.data.fake_dataset import main
    root = str(tmp_path_factory.mktemp('fake_zju3'))
    main(['--root', root, '--frames', '3', '--views', '1,7',
          '--img-size', '128', '--verts', '256'])
    return root


def _env():
    return dict(os.environ, OMP_NUM_THREADS='1')


def run_cli(module, argv, nprocs=None):
    """Exit codes and outputs of `module.main(argv)` in the worker: one
    process, or nprocs ranks joined by the manual flags. Every process
    is killed at TIMEOUT seconds."""
    port = _free_port()
    ranks = [None] if nprocs is None else range(nprocs)
    procs = []
    for r in ranks:
        cmd = [sys.executable, WORKER, 'cli', module] + list(argv)
        if r is not None:
            cmd += ['--coordinator', f'127.0.0.1:{port}', '--num-processes',
                    str(nprocs), '--process-id', str(r), '--dist-backend',
                    'gloo']
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=_env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    res = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        res.append((p.returncode, out))
    return res


def _ok(res):
    for rank, (rc, out) in enumerate(res):
        assert rc == 0, f'rank {rank} rc {rc}:\n{out[-4000:]}'


def _tsv(path):
    with open(path) as f:
        rows = [line.rstrip('\n').split('\t') for line in f]
    return rows


def test_train_two_ranks_equal_one(tmp_path, data_root):
    outs = {}
    for name, n in (('one', None), ('two', 2)):
        out = str(tmp_path / name)
        cfg = tiny_config(tmp_path / f'{name}.yaml', data_root, out,
                          max_epochs=1, checkpoint_every_n_epochs=1)
        _ok(run_cli('arah_tpu_torch.cli.train', [cfg, '--device', 'cpu'],
                    nprocs=n))
        outs[name] = out
    tsv = {k: _tsv(os.path.join(v, 'metrics.tsv')) for k, v in outs.items()}
    # one header and step 0's row, written once
    assert [r[0] for r in tsv['two']] == ['step', '0'] == \
        [r[0] for r in tsv['one']]
    assert tsv['two'][0] == tsv['one'][0]
    for a, b in zip(tsv['two'][1][1:], tsv['one'][1][1:]):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)) + 1e-12, \
            (a, b)
    blobs = {}
    for k, v in outs.items():
        ck = os.path.join(v, 'checkpoints')
        assert sorted(os.listdir(ck)) == ['LAST', 'META.json',
                                          'step_00000003']
        with open(os.path.join(ck, 'META.json')) as f:
            assert json.load(f) == {'epoch': 1, 'step': 3}
        blobs[k] = torch.load(os.path.join(ck, 'step_00000003', 'state.pt'),
                              weights_only=False)
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    two = dict(tree_leaves_with_path(blobs['two']['params']))
    n_far = n_all = 0
    for path, a in tree_leaves_with_path(blobs['one']['params']):
        d = (two[path] - a).abs()
        assert d.max() <= 2 * 3 * 1e-3, (path, float(d.max()))
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= n_all / 1000, (n_far, n_all)


def test_exit_after_agreed(tmp_path, data_root):
    """`--devices 2` starts two local ranks; `--exit-after 0` is rank 0's
    decision, taken by both after the first step: both checkpoint at step
    1 and the CLI exits with code 2."""
    out = str(tmp_path / 'out')
    cfg = tiny_config(tmp_path / 'cfg.yaml', data_root, out, max_epochs=50)
    r = subprocess.run(
        [sys.executable, '-m', 'arah_tpu_torch.cli.train', cfg, '--device',
         'cpu', '--devices', '2', '--exit-after', '0', '--epochs-per-run',
         '50'], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 2, (r.stdout[-2000:], r.stderr[-3000:])
    assert r.stdout.count('exit-after reached') == 2
    with open(os.path.join(out, 'checkpoints', 'META.json')) as f:
        assert json.load(f) == {'epoch': 0, 'step': 1}


def test_failed_rank_fails_the_cli(tmp_path):
    """A rank that fails (here both: the config names no dataset) makes
    `--devices 2` exit non-zero, and no rank is left waiting."""
    cfg = tiny_config(tmp_path / 'cfg.yaml', str(tmp_path / 'missing'),
                      str(tmp_path / 'out'), max_epochs=1)
    r = subprocess.run(
        [sys.executable, '-m', 'arah_tpu_torch.cli.train', cfg, '--device',
         'cpu', '--devices', '2'], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=TIMEOUT)
    assert r.returncode == 1, (r.stdout[-2000:], r.stderr[-3000:])
    assert "launch_local: the ranks' exit codes" in r.stdout


def test_placement_rule():
    import socket
    from arah_tpu_torch.parallel import distributed
    host = socket.gethostname()
    with pytest.raises(ValueError, match='share cuda:0'):
        distributed.check_placement('nccl', [(host, 'cuda:0'),
                                             (host, 'cuda:0')])
    distributed.check_placement('gloo', [(host, 'cuda:0'), (host, 'cuda:0')])
    distributed.check_placement('nccl', [(host, 'cuda:0'), (host, 'cuda:1'),
                                         ('other', 'cuda:0')])
    with pytest.raises(ValueError, match='nccl needs CUDA'):
        distributed.initialize('127.0.0.1:1', 2, 0, backend='nccl',
                               device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            distributed.initialize('127.0.0.1:1', 2, 0, device='cuda')
