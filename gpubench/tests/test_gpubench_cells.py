"""Each cell at a size the CPU holds (`tiny.py`), its whole run but the
look for a chip: correct as it stands; not correct with the timed path
broken underneath, once for each fault the cell can have; and the
control, the reference one precision lower in the program's place, not
correct either. A last test runs a cell on the card (skipped here)."""
import json
import os
import subprocess
import sys

import pytest

from gpubench import harness
from gpubench.tests.tiny import HERE, ROOT, cells, load, run_tiny, tiny_run


def kind_of(cell):
    return load(HERE, 'traffic', cell['traffic'] + '.json')['kind']


RENDER = [w for w, c in cells().items() if kind_of(c) == 'render']
FAULTS = [(w, f) for w in RENDER
          for f in ('half_batch', 'altered_answer', 'moved_roots')]


def lines(out):
    return '\n'.join(harness.check_line(c) for c in out.checks)


@pytest.mark.parametrize('workload', RENDER)
def test_tiny_run_is_correct(workload):
    out, ok = run_tiny(workload)
    assert ok, lines(out)


@pytest.mark.parametrize('workload,fault', FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault):
    out, ok = run_tiny(workload, fault=fault)
    assert not ok, lines(out)


@pytest.mark.parametrize('workload', RENDER)
def test_the_control_is_not_correct(workload):
    import torch
    from gpubench.control import control_checks
    torch.set_num_threads(4)
    checks = control_checks(tiny_run(workload))
    assert not harness.verdict(checks), '\n'.join(
        harness.check_line(c) for c in checks)


def test_the_fit_is_kept_under_its_key_and_read_back_whole(tmp_path):
    import torch
    from gpubench import inputs
    from gpubench.reference import config as rconfig
    torch.set_num_threads(4)
    cfg = load(HERE, 'configs', 'arah_zju313.json')
    ref_cfg = rconfig.model_config(cfg)

    def scene():
        return inputs.build_scene(cfg, ref_cfg, 'cpu', fit_steps=2,
                                  cache_dir=str(tmp_path))
    made, read = scene(), scene()
    key = inputs.fit_key(cfg, 2, torch.device('cpu'))
    # one file, at its key's fixed name: no temporary left behind
    assert os.listdir(tmp_path) == [f'fit-{key}.pt']
    assert (made.fit_cached, read.fit_cached) == (False, True)
    assert made.fit_loss == read.fit_loss
    for a, b in zip(made.params['hypernet']['hypo_init']
                    + [v for lyr in made.params['skinning']['layers']
                       for v in lyr.values()],
                    read.params['hypernet']['hypo_init']
                    + [v for lyr in read.params['skinning']['layers']
                       for v in lyr.values()]):
        assert torch.equal(a, b)
    # what the fit depends on is in the key
    assert inputs.fit_key(cfg, 3, torch.device('cpu')) != key
    other = json.loads(json.dumps(cfg))
    other['model']['skinning_decoder_kwargs']['d_hidden'] = 64
    assert inputs.fit_key(other, 2, torch.device('cpu')) != key


@pytest.mark.chip
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the run needs the card')
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'gpubench', 'run.py'),
         '--workload', 'zju313.novel_view', '--seed', '5', '--seconds', '3',
         '--trace', '0'], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert '"correct": true' in proc.stdout.strip().splitlines()[-1]
