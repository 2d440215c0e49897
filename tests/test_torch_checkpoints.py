"""The port's checkpoints (`train/checkpoints.py`) on the CPU: the state
dict converters against the JAX package's on a synthetic reference state
dict (every key layout they read; exact), `load_torch_checkpoint` on a
file, and save -> restore of the train state (parameters, Adam moments,
schedule and step: exact), the parameters-only restore of evaluation,
and `init_params_from_cfg` loading the pretrained MetaAvatar and SNARF
checkpoints."""
import os

import numpy as np
import pytest
import torch

from test_renderer import small_config
from torch_port_util import port_cfg


def synthetic_state_dict(cfg, rng):
    """Reference-layout keys for `cfg` (a JAX ModelConfig) with random
    values (the converters copy, whatever the shapes): the hypernet with
    hypo_params_init on all but the last layer, the FiLM mapping network
    and pose encoder, weight-normed skinning layers, colour layers with
    one plain layer, deviation, latent and camera leaves."""
    from arah_tpu.nn.hypernet import siren_layer_dims
    sd = {}

    def put(key, *shape):
        sd[key] = rng.randn(*shape).astype(np.float32)

    def fc(prefix, n_hidden=2):
        for j in range(n_hidden):
            put(f'{prefix}net.{j}.net.0.weight', 4, 3)
            put(f'{prefix}net.{j}.net.0.bias', 4)
            put(f'{prefix}net.{j}.net.1.weight', 4)
            put(f'{prefix}net.{j}.net.1.bias', 4)
        put(f'{prefix}net.{n_hidden}.weight', 5, 4)
        put(f'{prefix}net.{n_hidden}.bias', 5)

    def pose_encoder(prefix):
        put(f'{prefix}layer_0.weight', 6, 9)
        put(f'{prefix}layer_0.bias', 6)
        for j in range(3):
            put(f'{prefix}layers.{j}.0.weight', 6, 6)
            put(f'{prefix}layers.{j}.0.bias', 6)
            put(f'{prefix}layers.{j}.2.weight', 6, 6)
            put(f'{prefix}layers.{j}.2.bias', 6)

    dims = siren_layer_dims(cfg.hypernet)
    for i, (d_in, d_out) in enumerate(dims):
        base = f'sdf_decoder.net.layers.{i}.' + (
            'hyper_linear.' if i < len(dims) - 1 else '')
        fc(base + 'hypo_params.')
        if i < len(dims) - 1:
            put(base + 'hypo_params_init', 1, d_in * d_out + d_out)
    for idx in (0, 2, 4, 6):
        put(f'sdf_decoder.net.mapping_network.network.{idx}.weight', 7, 7)
        put(f'sdf_decoder.net.mapping_network.network.{idx}.bias', 7)
    pose_encoder('sdf_decoder.pose_encoder.')
    for l in range(cfg.skinning.n_layers + 1):
        p = f'skinning_model.skinning_decoder_fwd.lin{l}.'
        put(p + 'weight_v', 8, 3)
        put(p + 'weight_g', 8, 1)
        put(p + 'bias', 8)
    for l in range(cfg.color.n_layers + 1):
        p = f'color_decoder.lin{l}.'
        if l == 1:
            put(p + 'weight', 8, 3)
        else:
            put(p + 'weight_v', 8, 3)
            put(p + 'weight_g', 8, 1)
        put(p + 'bias', 8)
    put('deviation_decoder.variance', 1)
    put('latent.weight', 3, 128)
    put('cam_rots', 2, 4)
    put('cam_trans', 2, 3)
    for i in range(len(dims)):
        put(f'decoder.net.net.{i}.0.weight', 4, 3)
        put(f'decoder.net.net.{i}.0.bias', 4)
    return sd


def assert_same_tree(port, ref, path=()):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            assert_same_tree(port[k], ref[k], path + (k,))
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same_tree(a, b, path + (i,))
    else:
        assert port.dtype == torch.float32, path
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                      err_msg=str(path))


def test_converters_vs_jax():
    from arah_tpu.train import checkpoints as jc
    from arah_tpu_torch.train import checkpoints as pc
    cfg = small_config()
    sd = synthetic_state_dict(cfg, np.random.RandomState(0))
    full = {f'model.{k}': v for k, v in sd.items()}
    jsd = jc.strip_prefix(full, 'model.')
    psd = pc.strip_prefix({k: torch.as_tensor(v) for k, v in full.items()},
                          'model.')
    assert sorted(jsd) == sorted(psd)
    assert_same_tree(pc.convert_model_state_dict(psd, port_cfg(cfg)),
                     jc.convert_model_state_dict(jsd, cfg))
    assert_same_tree(pc.convert_hypernet(psd, port_cfg(cfg).hypernet),
                     jc.convert_hypernet(jsd, cfg.hypernet))
    assert_same_tree(
        pc.convert_fc_block(psd, 'sdf_decoder.net.layers.0.hyper_linear.'
                            'hypo_params.'),
        jc.convert_fc_block(jsd, 'sdf_decoder.net.layers.0.hyper_linear.'
                            'hypo_params.'))
    assert_same_tree(
        pc.convert_pose_encoder(psd, 'sdf_decoder.pose_encoder.'),
        jc.convert_pose_encoder(jsd, 'sdf_decoder.pose_encoder.'))
    assert_same_tree(pc.load_metaavatar_hypo_init(psd, port_cfg(
        cfg).hypernet), jc.load_metaavatar_hypo_init(jsd, cfg.hypernet))
    snarf = {f'skinning_decoder_fwd.{k.split("fwd.", 1)[1]}': v
             for k, v in psd.items() if 'skinning_decoder_fwd.' in k}
    assert_same_tree(
        pc.load_snarf_skinning(snarf, cfg.skinning.n_layers),
        jc.load_snarf_skinning({k: v.numpy() for k, v in snarf.items()},
                               cfg.skinning.n_layers))


def test_load_torch_checkpoint(tmp_path):
    from arah_tpu.train import checkpoints as jc
    from arah_tpu_torch.train import checkpoints as pc
    sd = {'a.weight': torch.randn(3, 2), 'b': torch.arange(4.0)}
    for wrap in ('state_dict', 'model', None):
        p = str(tmp_path / f'{wrap}.ckpt')
        torch.save({wrap: sd, 'epoch': 3} if wrap else sd, p)
        got, ref = pc.load_torch_checkpoint(p), jc.load_torch_checkpoint(p)
        assert sorted(got) == sorted(ref) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(got[k].numpy(), ref[k])


def _state(seed, steps=0):
    """A small model's TrainState on the CPU after `steps` Adam updates
    of random gradients (a cosine schedule, so it has state too)."""
    from arah_tpu_torch.model import init_model_params
    from arah_tpu_torch.parallel.train_step import TrainState, trainable
    from arah_tpu_torch.train.optim import OptimConfig, make_optimizer
    cfg = port_cfg(small_config())
    params = trainable(init_model_params(
        torch.Generator().manual_seed(seed), cfg, n_latent_frames=2,
        device='cpu'))
    opt, _ = make_optimizer(OptimConfig(lr_schedule='cosine',
                                        lr_decay_steps=10), params)
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(steps):
        opt.zero_grad()
        for group in opt.adam.param_groups:
            for p in group['params']:
                p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    return TrainState(params, opt, steps)


def _leaves(tree):
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    return {p: l.detach().clone() for p, l in tree_leaves_with_path(tree)}


def test_save_restore_is_exact(tmp_path):
    from arah_tpu_torch.train import checkpoints as pc
    ckpt = str(tmp_path / 'checkpoints')
    os.makedirs(ckpt)
    assert pc.restore_checkpoint(ckpt, _state(1)) == (None, None)
    src = _state(0, steps=3)
    path = pc.save_checkpoint(ckpt, 3, src)
    assert os.path.basename(path) == 'step_00000003'
    assert pc.latest_step(ckpt) == 3
    dst = _state(7)
    got, step = pc.restore_checkpoint(ckpt, dst)
    assert step == 3 and got.step == 3
    a, b = _leaves(got.params), _leaves(src.params)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = got.optimizer.adam.state_dict(), src.optimizer.adam.state_dict()
    assert sa['param_groups'] == sb['param_groups']
    assert sorted(sa['state']) == sorted(sb['state'])
    for i in sa['state']:
        for k in sb['state'][i]:
            assert torch.equal(sa['state'][i][k], sb['state'][i][k]), (i, k)
    assert got.optimizer.schedule.state_dict() == \
        src.optimizer.schedule.state_dict()
    # the restored state steps on as the saved one does
    for s in (got, src):
        s.optimizer.zero_grad()
        g = torch.Generator().manual_seed(11)
        for group in s.optimizer.adam.param_groups:
            for p in group['params']:
                p.grad = torch.randn(p.shape, generator=g)
        s.optimizer.step()
    a, b = _leaves(got.params), _leaves(src.params)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_restore_for_evaluation(tmp_path):
    """Validation restores the parameters alone (no optimizer); a tree of
    another shape is refused."""
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.train import checkpoints as pc
    ckpt = str(tmp_path / 'checkpoints')
    os.makedirs(ckpt)
    src = _state(0, steps=2)
    pc.save_checkpoint(ckpt, 2, src)
    dst = _state(3)
    got, step = pc.restore_checkpoint(ckpt, TrainState(dst.params, None, 0))
    assert step == 2 and got.step == 2
    a, b = _leaves(got.params), _leaves(src.params)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    bad = {**dst.params, 'latent': torch.zeros(9, 128)}
    with pytest.raises(ValueError, match='checkpoint shape'):
        pc.restore_checkpoint(ckpt, TrainState(bad, None, 0))


def test_init_params_loads_pretrained(tmp_path):
    """`model.geometry_net` (a MetaAvatar checkpoint) and
    `model.skinning_net2` (a SNARF one) reach the train-mode parameter
    tree through the converters; in val mode they are not read."""
    from arah_tpu.train import checkpoints as jc
    from arah_tpu_torch.config.factory import init_params_from_cfg
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'configs', 'fake', 'FAKE-ZJU.yaml'),
        default_config_path())
    mcfg = model_config_from_cfg(cfg)
    rng = np.random.RandomState(2)
    from arah_tpu_torch.nn.hypernet import siren_layer_dims
    geo = {}
    for i, (d_in, d_out) in enumerate(siren_layer_dims(mcfg.hypernet)):
        geo[f'decoder.net.net.{i}.0.weight'] = torch.as_tensor(
            rng.randn(d_out, d_in).astype(np.float32))
        geo[f'decoder.net.net.{i}.0.bias'] = torch.as_tensor(
            rng.randn(d_out).astype(np.float32))
    skin = {}
    init = init_params_from_cfg(0, cfg, mcfg, device='cpu')
    for l, lyr in enumerate(init['skinning']['layers']):
        for k, name in (('v', 'weight_v'), ('g', 'weight_g'), ('b', 'bias')):
            skin[f'skinning_decoder_fwd.lin{l}.{name}'] = torch.as_tensor(
                rng.randn(*lyr[k].shape).astype(np.float32))
    torch.save({'model': geo}, str(tmp_path / 'geo.pt'))
    torch.save({'model': skin}, str(tmp_path / 'skin.pt'))
    cfg['model']['geometry_net'] = str(tmp_path / 'geo.pt')
    cfg['model']['skinning_net2'] = str(tmp_path / 'skin.pt')
    params = init_params_from_cfg(0, cfg, mcfg, device='cpu')
    ref = jc.load_metaavatar_hypo_init(
        {k: v.numpy() for k, v in geo.items()}, mcfg.hypernet)
    assert_same_tree(params['hypernet']['hypo_init'], ref)
    ref = jc.load_snarf_skinning({k: v.numpy() for k, v in skin.items()},
                                 mcfg.skinning.n_layers)
    assert_same_tree(params['skinning'], ref)
    val = init_params_from_cfg(0, cfg, mcfg, mode='val', device='cpu')
    for a, b in zip(val['hypernet']['hypo_init'],
                    init['hypernet']['hypo_init']):
        assert torch.equal(a, b)
