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


@pytest.fixture(scope='module')
def odp_root(tmp_path_factory, data_root):
    """The fixture with camera 1 moved back (f 250 at 1024 px, so 125 in
    the ODP dataset's 512 x 512 frame): the body spans a few thousand
    pixels, which keeps the CPU render short."""
    import shutil
    root = str(tmp_path_factory.mktemp('odp') / 'data')
    shutil.copytree(data_root, root)
    path = os.path.join(root, 'CoreView_313', 'cam_params.json')
    with open(path) as f:
        cams = json.load(f)
    cams['1']['K'] = [[250.0, 0, 512.0], [0, 250.0, 512.0], [0, 0, 1.0]]
    with open(path, 'w') as f:
        json.dump(cams, f)
    return root


def test_cli_test_vs_jax(tmp_path, odp_root, capsys):
    """`cli.test` on the CPU: it restores the checkpoint, writes the four
    PNG kinds of each frame and `vis.mp4` (each sample `write_jpeg` of the
    frame's PNGs side by side), and frame 0's rgb and normal maps are
    JAX's `render_frame_rays` and `render_normal_maps` on the same
    parameters, quantised: the rgb within 1 level at every pixel and
    equal at >= 0.99 of them (float roundoff moves a few across a level),
    each normal map's foreground agreeing at >= 0.99 of the pixels and
    its levels equal at the median. A second run with `--free-viewpoint
    2` writes its frames, blank but for the canonical maps: one camera
    makes every spiral matrix NaN, as in JAX."""
    import jax
    import jax.numpy as jnp
    from arah_tpu.config import load_config as jload
    from arah_tpu.config import model_config_from_cfg as jmodel_cfg
    from arah_tpu.data.loader import frame_from_item as jframe
    from arah_tpu.data.odp import ODPDataset
    from arah_tpu.eval.evaluator import render_frame_rays, scatter_image
    from arah_tpu.eval.mesh_vis import render_normal_maps
    from arah_tpu_torch.cli import test as cli_test
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg,
                                              optim_config_from_cfg)
    from arah_tpu_torch.data.loader import frame_from_item
    from arah_tpu_torch.eval.evaluator import _to_u8, read_video
    from arah_tpu_torch.nn.hypernet import siren_layer_dims
    from arah_tpu_torch.nn.siren import siren_apply
    from arah_tpu_torch.parallel.train_step import TrainState, trainable
    from arah_tpu_torch.render.renderer import generate_sdf
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.train.optim import make_optimizer
    from arah_tpu_torch.utils.image import read_image, write_jpeg
    from arah_tpu_torch.utils.meshing import grid_chunk
    from arah_tpu_torch.utils.tree import tree_map

    out = str(tmp_path / 'out')
    cfg_path = tiny_config(tmp_path / 'cfg.yaml', odp_root, out)
    cfg = load_config(cfg_path, default_config_path())
    mcfg = model_config_from_cfg(cfg)
    # a checkpoint at step 3 of parameters drawn from seed 5, the SIREN
    # lowered by its median over the grid so that the mesh has a surface
    params = init_params_from_cfg(5, cfg, mcfg, get_dataset('train', cfg),
                                  mode='val', device='cpu')
    odp_kw = dict(pose_dir='models', cam_name='1',
                  smpl_misc_dir=cfg['data']['smpl_misc'],
                  subjects=('CoreView_313',), end_frame=1)
    item = ODPDataset(odp_root, **odp_kw)[0]
    fd = frame_from_item(item, 'cpu')
    with torch.no_grad():
        gen = generate_sdf(params, mcfg, fd.rots, fd.Jtrs,
                           params['latent'][-1])
        shift = siren_apply(gen, grid_chunk(16, 0, 16 ** 3)).median()
        d_in, d_out = siren_layer_dims(mcfg.hypernet)[-1]
        params['hypernet']['hypo_init'][-1][d_in * d_out:] -= shift
    tparams = trainable(params)
    opt, _ = make_optimizer(optim_config_from_cfg(cfg), tparams)
    ckpt_lib.save_checkpoint(os.path.join(out, 'checkpoints'), 3,
                             TrainState(tparams, opt, 3))

    capsys.readouterr()
    cli_test.main([cfg_path, '--device', 'cpu', '--pose-dir', 'models',
                   '--end-frame', '1', '--mesh-res', '32'])
    text = capsys.readouterr().out
    assert 'loaded checkpoint step 3' in text
    assert '[1/1] rendered (render' in text and 'grid' in text
    vis = os.path.join(out, 'vis')
    pngs = [read_image(os.path.join(vis, f'{k}_000000.png'))
            for k in ('rgb', 'normal', 'front', 'back')]
    assert [p.shape for p in pngs] == [(512, 512, 3)] * 4
    samples, fps, wh = read_video(os.path.join(vis, 'vis.mp4'))
    assert (len(samples), fps, wh) == (1, 20, (2048, 512))
    assert samples[0] == write_jpeg(np.concatenate(pngs, axis=1))

    # JAX on the same parameters and item
    jparams = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(),
                                                 params))
    jcfg = jmodel_cfg(jload(cfg_path, 'configs/default.yaml'))
    jitem = ODPDataset(odp_root, **odp_kw)[0]
    latent = jparams['latent'][-1]
    jfd = jframe(jitem)
    rgb, _, _, _ = render_frame_rays(jparams, jcfg, jfd, jitem, latent)
    ref = _to_u8(scatter_image(np.asarray(rgb),
                               np.asarray(jitem['inputs.image_mask'])))
    d = np.abs(pngs[0].astype(int) - ref)
    assert ref.any() and d.max() <= 1 and (d == 0).mean() >= 0.99, (
        d.max(), (d == 0).mean())
    maps = render_normal_maps(jparams, jcfg, jfd, jitem, latent,
                              resolution=32)
    for png, m in zip(pngs[1:], maps):
        m = _to_u8(np.asarray(m))
        fg_p, fg_j = png.any(-1), m.any(-1)
        assert fg_j.sum() > 100
        assert (fg_p == fg_j).mean() >= 0.99
        assert np.median(np.abs(png.astype(int) - m)) == 0

    cli_test.main([cfg_path, '--device', 'cpu', '--pose-dir', 'models',
                   '--end-frame', '2', '--mesh-res', '16',
                   '--free-viewpoint', '2'])
    assert len(read_video(os.path.join(vis, 'vis.mp4'))[0]) == 2
    for k in ('rgb', 'normal', 'front', 'back'):
        assert os.path.exists(os.path.join(vis, f'{k}_000001.png'))
    # one camera gives the spiral no spread: its matrices are NaN, as in
    # JAX, so the rgb and posed normal maps are blank and only the
    # canonical maps, which take no camera, are drawn
    from arah_tpu_torch.data.odp import ODPDataset as PortODP
    spiral = np.asarray(cli_test.spiral_cameras(PortODP(odp_root, **odp_kw),
                                                2))
    assert np.isnan(spiral[:, :3]).all()
    for i in range(2):
        lit = {k: read_image(os.path.join(vis, f'{k}_{i:06d}.png')).any()
               for k in ('rgb', 'normal', 'front', 'back')}
        assert lit == {'rgb': False, 'normal': False, 'front': True,
                       'back': True}, (i, lit)


def test_cli_test_refuses_multi_device_flags(tmp_path, data_root):
    from arah_tpu_torch.cli import test as cli_test
    cfg = tiny_config(tmp_path / 'cfg.yaml', data_root, str(tmp_path / 'o'))
    for flag in ('--devices', '--num-processes', '--process-id',
                 '--coordinator'):
        with pytest.raises(SystemExit) as e:
            cli_test.main([cfg, '--device', 'cpu', flag, '2'])
        assert e.value.code == 2
