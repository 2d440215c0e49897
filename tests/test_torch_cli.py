"""The port's CLIs end to end on the CPU (`--device cpu`), at a tiny
model on a fake ZJU dataset written by the port's own writer: `cli.train`
for 2 epochs writes every file (metrics, validation metrics, the
checkpoints with LAST, META.json and BEST.json) and a rerun resumes;
`--exit-after` checkpoints and exits with code 2 in a subprocess (the
job-chaining contract); `cli.validate --novel-view` writes finite metrics
and the frame PNGs; the data CLI writes the fixture; `--device cuda`
without a GPU raises."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def tiny_config(path, data, out, **training):
    lines = [
        f'inherit_from: {REPO}/configs/fake/FAKE-ZJU.yaml',
        'data:', f'  path: {data}',
        f'  smpl_misc: {data}/body_models/misc',
        '  img_size: [32, 32]', '  num_fg_samples: 16',
        '  num_bg_samples: 16',
        'model:',
        '  decoder_kwargs: {hidden_features: 32, num_hidden_layers: 2,',
        '                   use_FiLM: true}',
        '  skinning_decoder_kwargs: {d_hidden: 32, n_layers: 3}',
        '  renderer_kwargs: {d_hidden: 32, n_layers: 3, multires_view: 4}',
        '  n_steps: 16', '  near_surface_samples: 4',
        '  far_surface_samples: 4',
        'training:', f'  out_dir: {out}',
    ] + [f'  {k}: {v}' for k, v in training.items()]
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return str(path)


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    from arah_tpu_torch.data.fake_dataset import main
    root = str(tmp_path_factory.mktemp('fake_zju'))
    main(['--root', root, '--frames', '2', '--views', '1,7',
          '--img-size', '128', '--verts', '256'])
    return root


def test_train_resume_validate(tmp_path, data_root, capsys):
    from arah_tpu_torch.cli import train, validate
    out = str(tmp_path / 'out')
    cfg = tiny_config(tmp_path / 'cfg.yaml', data_root, out, max_epochs=2,
                      checkpoint_every_n_epochs=1, validate_every_n_epochs=1)
    train.main([cfg, '--device', 'cpu'])
    ck = os.path.join(out, 'checkpoints')
    for f in ('metrics.tsv', 'val_metrics.tsv'):
        assert os.path.exists(os.path.join(out, f)), f
    for f in ('LAST', 'META.json', 'BEST.json'):
        assert os.path.exists(os.path.join(ck, f)), f
    with open(os.path.join(ck, 'META.json')) as f:
        assert json.load(f) == {'epoch': 2, 'step': 4}
    with open(os.path.join(ck, 'LAST')) as f:
        assert f.read() == '4'
    with open(os.path.join(out, 'metrics.tsv')) as f:
        rows = [line.rstrip('\n').split('\t') for line in f]
    assert rows[0][0] == 'step' and 'loss' in rows[0]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    with open(os.path.join(out, 'val_metrics.tsv')) as f:
        val = [line.rstrip('\n').split('\t') for line in f]
    assert [r[0] for r in val] == ['step', '2', '4']

    more = tiny_config(tmp_path / 'more.yaml', data_root, out, max_epochs=3,
                       checkpoint_every_n_epochs=1)
    capsys.readouterr()
    train.main([more, '--device', 'cpu'])
    assert 'resumed from step 4 (epoch 2)' in capsys.readouterr().out
    with open(os.path.join(ck, 'META.json')) as f:
        assert json.load(f) == {'epoch': 3, 'step': 6}

    validate.main([cfg, '--novel-view', '--device', 'cpu', '--chunk', '128'])
    assert 'loaded checkpoint step 6' in capsys.readouterr().out
    with open(os.path.join(out, 'val', 'metrics.json')) as f:
        m = json.load(f)
    assert len(m['per_frame']) == 1
    for k in ('psnr', 'ssim'):
        assert np.isfinite(m['mean'][k]), m
    assert any(k.startswith('lpips') for k in m['mean'])
    for f in ('rgb_000000.png', 'normal_000000.png', 'gt_000000.png'):
        assert os.path.getsize(os.path.join(out, 'val', f)) > 0


def test_exit_after_exits_2(tmp_path, data_root):
    out = str(tmp_path / 'out')
    cfg = tiny_config(tmp_path / 'cfg.yaml', data_root, out, max_epochs=50)
    r = subprocess.run(
        [sys.executable, '-m', 'arah_tpu_torch.cli.train', cfg,
         '--device', 'cpu', '--exit-after', '0', '--epochs-per-run', '50'],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2, r.stderr[-2000:]
    assert 'exit-after reached' in r.stdout
    with open(os.path.join(out, 'checkpoints', 'META.json')) as f:
        assert json.load(f) == {'epoch': 0, 'step': 1}


def test_cuda_without_a_gpu_raises(tmp_path, data_root, monkeypatch):
    from arah_tpu_torch.cli import train
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = tiny_config(tmp_path / 'cfg.yaml', data_root, str(tmp_path / 'o'))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train.main([cfg])
