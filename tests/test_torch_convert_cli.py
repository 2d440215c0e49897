"""The port's checkpoint converter CLI (`cli/convert_checkpoint.py`) on the
CPU: a reference-layout Lightning checkpoint at the shapes of
`test_torch_cli.py:tiny_config` (`chip_smoke.py:reference_state_dict`,
the converter's inverse on a parameter tree of the config) goes through
the CLI; its `step_0` restores, leaf for leaf and exactly, to the
in-process `convert_model_state_dict` of the same state dict and to the
JAX package's converter; then `cli.validate --device cpu --novel-view`
restores it on its parameters-only path, and its rgb PNG is byte-equal to
an in-process `evaluate_frame` and `save_image` of the same item with
the restored parameters (as `tests/test_convert_cli.py` asserts for
JAX)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_checkpoints import assert_same_tree
from test_torch_cli import REPO, tiny_config

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def converted(tmp_path_factory):
    """(config path, out dir, reference state dict, the CLI's stdout)."""
    from arah_tpu_torch.cli import convert_checkpoint
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.data.fake_dataset import main as write_fixture
    sys.path.insert(0, REPO)
    from chip_smoke import reference_state_dict
    tmp = tmp_path_factory.mktemp('convert')
    data = str(tmp / 'data')
    write_fixture(['--root', data, '--frames', '2', '--views', '1,7',
                   '--img-size', '128', '--verts', '256'])
    out = str(tmp / 'out')
    cfg_path = tiny_config(tmp / 'cfg.yaml', data, out)
    cfg = load_config(cfg_path, default_config_path())
    params = init_params_from_cfg(3, cfg, model_config_from_cfg(cfg),
                                  get_dataset('train', cfg), mode='val',
                                  device='cpu')
    sd = reference_state_dict(params)
    ckpt = str(tmp / 'last.ckpt')
    torch.save({'state_dict': sd, 'epoch': 7}, ckpt)
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        convert_checkpoint.main(['--config', cfg_path, '--torch-ckpt', ckpt,
                                 '--out-dir', os.path.join(out,
                                                           'checkpoints')])
    return cfg_path, out, sd, buf.getvalue()


def _restored(cfg_path, out):
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    cfg = load_config(cfg_path, default_config_path())
    model_cfg = model_config_from_cfg(cfg)
    params = init_params_from_cfg(0, cfg, model_cfg,
                                  get_dataset('train', cfg), mode='val',
                                  device='cpu')
    state, step = ckpt_lib.restore_checkpoint(
        os.path.join(out, 'checkpoints'), TrainState(params, None, 0))
    return cfg, model_cfg, state, step


def test_cli_equals_in_process_and_jax(converted):
    from arah_tpu.config import load_config as jload, model_config_from_cfg
    from arah_tpu.train import checkpoints as jc
    from arah_tpu_torch.train import checkpoints as pc
    cfg_path, out, sd, text = converted
    assert 'step_00000000' in text
    assert os.path.exists(os.path.join(out, 'checkpoints',
                                       'step_00000000', 'state.pt'))
    _, model_cfg, state, step = _restored(cfg_path, out)
    assert step == 0 and state.step == 0
    direct = pc.convert_model_state_dict(pc.strip_prefix(sd, 'model.'),
                                         model_cfg)
    assert_same_tree(state.params, jax_tree(direct))
    jcfg = model_config_from_cfg(jload(
        cfg_path, os.path.join(REPO, 'configs', 'default.yaml')))
    ref = jc.convert_model_state_dict(
        jc.strip_prefix({k: v.numpy() for k, v in sd.items()}, 'model.'),
        jcfg)
    assert_same_tree(state.params, ref)


def jax_tree(tree):
    """A port tree with numpy leaves (`assert_same_tree`'s reference)."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree(v) for v in tree]
    return tree.numpy()


def test_validate_restores_the_conversion(converted, capsys):
    from arah_tpu_torch.cli import validate
    from arah_tpu_torch.config.factory import get_dataset
    from arah_tpu_torch.eval.evaluator import evaluate_frame, save_image
    cfg_path, out, _, _ = converted
    capsys.readouterr()
    validate.main([cfg_path, '--novel-view', '--max-frames', '1',
                   '--device', 'cpu'])
    assert 'loaded checkpoint step 0' in capsys.readouterr().out
    val = os.path.join(out, 'val')
    with open(os.path.join(val, 'metrics.json')) as f:
        assert np.isfinite(json.load(f)['mean']['psnr'])
    cfg, model_cfg, state, _ = _restored(cfg_path, out)
    item = get_dataset('val', cfg, subsampling_rate=30)[0]
    params = state.params
    d_idx = min(int(item['inputs.data_idx']), params['latent'].shape[0] - 1)
    m = evaluate_frame(params, model_cfg, item, params['latent'][d_idx])
    ref = os.path.join(out, 'rgb_inproc.png')
    save_image(ref, m['rgb_pred'])
    with open(ref, 'rb') as fa, \
            open(os.path.join(val, 'rgb_000000.png'), 'rb') as fb:
        assert fa.read() == fb.read()
