"""The port's validation and test CLIs over two gloo ranks on the CPU,
on the fixture and through the worker of `test_torch_dist_cli.py`:

- `cli.validate --novel-pose` over 3 frames: ragged shares (2 and 1),
  `metrics.json`'s rows equal to one process's, and every frame's PNGs;
  with `--devices 2` (each chunk split over two ranks) the rows within
  1e-4 of their magnitude.
- `cli.test` over 2 frames: every frame's PNGs and one `vis.mp4`; with
  `--devices 2` (each chunk split, rank 0 writing) one frame's."""
import json
import os
import subprocess
import sys

import torch

from test_torch_cli import tiny_config
from test_torch_dist_cli import (REPO, TIMEOUT, _env, _ok, data_root,  # noqa: F401
                                 run_cli)

torch.set_num_threads(2)


def test_validate_two_ranks_equal_one(tmp_path, data_root):
    metrics = {}
    for name, n in (('one', None), ('two', 2)):
        out = str(tmp_path / name)
        cfg = tiny_config(tmp_path / f'{name}.yaml', data_root, out)
        res = run_cli('arah_tpu_torch.cli.validate',
                      [cfg, '--device', 'cpu', '--novel-pose'], nprocs=n)
        _ok(res)
        with open(os.path.join(out, 'val', 'metrics.json')) as f:
            metrics[name] = json.load(f)
        pngs = sorted(os.listdir(os.path.join(out, 'val')))
        assert pngs == sorted(['metrics.json'] + [
            f'{k}_{i:06d}.png' for k in ('rgb', 'normal', 'gt')
            for i in range(3)])
        if n:
            # ragged shares: frames 0 and 2 on rank 0, frame 1 on rank 1
            assert res[0][1].count('/3] psnr') == 2
            assert res[1][1].count('/3] psnr') == 1
    assert len(metrics['one']['per_frame']) == 3
    assert metrics['two'] == metrics['one']
    # --devices 2: every chunk split over two local ranks, each rendering
    # half of it (another batch size: float roundoff in the CPU's
    # products), rank 0 writing
    out = str(tmp_path / 'sharded')
    cfg = tiny_config(tmp_path / 'sharded.yaml', data_root, out)
    r = subprocess.run(
        [sys.executable, '-m', 'arah_tpu_torch.cli.validate', cfg,
         '--device', 'cpu', '--novel-pose', '--devices', '2'], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert r.stdout.count('sharded eval over 2 ranks') == 2
    with open(os.path.join(out, 'val', 'metrics.json')) as f:
        sharded = json.load(f)
    for a, b in zip(sharded['per_frame'], metrics['one']['per_frame']):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]) + 1e-6, (k, a, b)


def test_cli_test_two_ranks(tmp_path, data_root):
    import shutil
    from arah_tpu_torch.eval.evaluator import read_video
    root = str(tmp_path / 'data')
    shutil.copytree(data_root, root)
    path = os.path.join(root, 'CoreView_313', 'cam_params.json')
    with open(path) as f:
        cams = json.load(f)
    # the camera moved back, so that the body spans few pixels (a short
    # render on the CPU)
    cams['1']['K'] = [[250.0, 0, 512.0], [0, 250.0, 512.0], [0, 0, 1.0]]
    with open(path, 'w') as f:
        json.dump(cams, f)
    out = str(tmp_path / 'out')
    cfg = tiny_config(tmp_path / 'cfg.yaml', root, out)
    res = run_cli('arah_tpu_torch.cli.test',
                  [cfg, '--device', 'cpu', '--pose-dir', 'models',
                   '--end-frame', '2', '--mesh-res', '16'], nprocs=2)
    _ok(res)
    assert '[1/2] rendered' in res[0][1] and '[2/2] rendered' in res[1][1]
    vis = os.path.join(out, 'vis')
    assert sorted(os.listdir(vis)) == sorted(['vis.mp4'] + [
        f'{k}_{i:06d}.png' for k in ('rgb', 'normal', 'front', 'back')
        for i in range(2)])
    samples, fps, wh = read_video(os.path.join(vis, 'vis.mp4'))
    assert (len(samples), fps, wh) == (2, 20, (2048, 512))
    # --devices 2: each chunk split over two local ranks, rank 0 drawing
    # the normal maps and writing
    out = str(tmp_path / 'sharded')
    cfg = tiny_config(tmp_path / 'sharded.yaml', root, out)
    r = subprocess.run(
        [sys.executable, '-m', 'arah_tpu_torch.cli.test', cfg, '--device',
         'cpu', '--pose-dir', 'models', '--end-frame', '1', '--mesh-res',
         '16', '--devices', '2'], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=TIMEOUT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert r.stdout.count('sharded render over 2 ranks') == 2
    assert r.stdout.count('[1/1] rendered') == 1
    vis = os.path.join(out, 'vis')
    assert sorted(os.listdir(vis)) == sorted(['vis.mp4'] + [
        f'{k}_000000.png' for k in ('rgb', 'normal', 'front', 'back')])
    assert len(read_video(os.path.join(vis, 'vis.mp4'))[0]) == 1
