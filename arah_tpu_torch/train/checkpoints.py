"""Checkpoints: save and resume of the train state with `torch.save`, and
converters from the reference's PyTorch state dicts into the port's
parameter tree. Port of `arah_tpu/train/checkpoints.py`.

The converters understand the three reference formats:
  * full ARAH Lightning checkpoints (`state_dict` with a `model.` prefix),
  * pretrained MetaAvatar SDF hypernet checkpoints (`model` with
    `decoder.` keys),
  * pretrained SNARF-style forward skinning checkpoints (`model` with
    `skinning_decoder_fwd.` keys).
Their inputs are dicts of arrays or tensors; their outputs float32 CPU
tensors, nested as the JAX converters nest them.

A checkpoint directory holds `step_<N>/state.pt` (the parameters, the Adam
state and the step), `LAST` (the newest step) and, as the trainer writes
them, `META.json` and `BEST.json`: the layout of the JAX trainer's
checkpoints. A JAX (orbax) checkpoint is not readable here: move JAX
parameters across with `convert.params_from_jax`."""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from arah_tpu_torch.nn.hypernet import HypernetConfig, siren_layer_dims

STATE_FILE = 'state.pt'


def _j(x):
    if torch.is_tensor(x):
        return x.detach().to('cpu', torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def strip_prefix(sd: Mapping, prefix: str):
    out = {}
    for k, v in sd.items():
        if k.startswith('module.'):
            k = k[len('module.'):]
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


# ------------------------------------------------------------ converters
def convert_fc_block(sd, prefix):
    """pytorch_prototyping FCBlock -> {'hidden': [...], 'last': {...}}.

    torch layout: net.0.net.0 (Linear), net.0.net.1 (LayerNorm), ...,
    net.<L-1> (final Linear).
    """
    hidden = []
    i = 0
    while f'{prefix}net.{i}.net.0.weight' in sd:
        hidden.append({
            'lin': {'w': _j(sd[f'{prefix}net.{i}.net.0.weight']),
                    'b': _j(sd[f'{prefix}net.{i}.net.0.bias'])},
            'ln': {'gamma': _j(sd[f'{prefix}net.{i}.net.1.weight']),
                   'beta': _j(sd[f'{prefix}net.{i}.net.1.bias'])},
        })
        i += 1
    last = {'w': _j(sd[f'{prefix}net.{i}.weight']),
            'b': _j(sd[f'{prefix}net.{i}.bias'])}
    return {'hidden': hidden, 'last': last}


def convert_pose_encoder(sd, prefix):
    layers = []
    j = 0
    while f'{prefix}layers.{j}.0.weight' in sd:
        layers.append({
            'fc1': {'w': _j(sd[f'{prefix}layers.{j}.0.weight']),
                    'b': _j(sd[f'{prefix}layers.{j}.0.bias'])},
            'fc2': {'w': _j(sd[f'{prefix}layers.{j}.2.weight']),
                    'b': _j(sd[f'{prefix}layers.{j}.2.bias'])},
        })
        j += 1
    return {'layer_0': {'w': _j(sd[f'{prefix}layer_0.weight']),
                        'b': _j(sd[f'{prefix}layer_0.bias'])},
            'layers': layers}


def convert_hypernet(sd, cfg: HypernetConfig, prefix='sdf_decoder.'):
    """Reference `HyperBVPNet` state dict -> the hypernet's parameters."""
    dims = siren_layer_dims(cfg)
    hyper_layers, hypo_init = [], []
    for i in range(len(dims)):
        if i < len(dims) - 1:
            base = f'{prefix}net.layers.{i}.hyper_linear.'
        else:
            base = f'{prefix}net.layers.{i}.'
        hyper_layers.append(convert_fc_block(sd, base + 'hypo_params.'))
        key = base + 'hypo_params_init'
        if key in sd:
            hypo_init.append(_j(sd[key]).reshape(-1))
        else:
            d_in, d_out = dims[i]
            hypo_init.append(torch.zeros((d_in * d_out + d_out,)))
    params = {'hyper_layers': hyper_layers, 'hypo_init': hypo_init}

    if cfg.use_film:
        net = f'{prefix}net.mapping_network.network.'
        params['mapping'] = {
            'lins': [{'w': _j(sd[f'{net}{idx}.weight']),
                      'b': _j(sd[f'{net}{idx}.bias'])} for idx in (0, 2, 4)],
            'last': {'w': _j(sd[f'{net}6.weight']),
                     'b': _j(sd[f'{net}6.bias'])}}
    if cfg.hierarchical_pose:
        params['pose_encoder'] = convert_pose_encoder(
            sd, f'{prefix}pose_encoder.')
    return params


def convert_wn_mlp(sd, prefix, n_layers):
    """Weight-normed `lin{l}` layers -> list of {'v','g','b'}."""
    layers = []
    for l in range(n_layers):
        if f'{prefix}lin{l}.weight_v' in sd:
            layers.append({'v': _j(sd[f'{prefix}lin{l}.weight_v']),
                           'g': _j(sd[f'{prefix}lin{l}.weight_g']
                                   ).reshape(-1, 1),
                           'b': _j(sd[f'{prefix}lin{l}.bias'])})
        else:
            layers.append({'w': _j(sd[f'{prefix}lin{l}.weight']),
                           'b': _j(sd[f'{prefix}lin{l}.bias'])})
    return layers


def convert_model_state_dict(sd: Mapping, cfg, latent: bool = True):
    """Full ARAH checkpoint (`model.`-stripped state dict) -> parameter
    tree; cfg is a `ModelConfig`."""
    params = {
        'hypernet': convert_hypernet(sd, cfg.hypernet, 'sdf_decoder.'),
        'skinning': {'layers': convert_wn_mlp(
            sd, 'skinning_model.skinning_decoder_fwd.',
            cfg.skinning.n_layers + 1)},
        'color': {'layers': convert_wn_mlp(
            sd, 'color_decoder.', cfg.color.n_layers + 1)},
        'deviation': {'variance': _j(sd['deviation_decoder.variance']
                                     ).reshape(())},
    }
    if cfg.color.pose_encoder == 'leap':
        params['color']['pose_encoder'] = convert_pose_encoder(
            sd, 'color_decoder.pose_encoder.')
    if latent and 'latent.weight' in sd:
        params['latent'] = _j(sd['latent.weight'])
    if 'cam_rots' in sd:
        params['cam_rots'] = _j(sd['cam_rots'])
        params['cam_trans'] = _j(sd['cam_trans'])
    return params


def load_metaavatar_hypo_init(sd: Mapping, cfg: HypernetConfig):
    """Pretrained MetaAvatar checkpoint -> frozen `hypo_init` vectors: for
    SIREN layer i, [decoder.net.net.{i}.0.weight.ravel();
    decoder.net.net.{i}.0.bias]."""
    dims = siren_layer_dims(cfg)
    out = []
    for i in range(len(dims)):
        w = _j(sd[f'decoder.net.net.{i}.0.weight']).reshape(-1)
        b = _j(sd[f'decoder.net.net.{i}.0.bias']).reshape(-1)
        out.append(torch.cat([w, b]))
    return out


def load_snarf_skinning(sd: Mapping, n_layers: int):
    """Pretrained SNARF forward-skinning checkpoint -> skinning params."""
    stripped = strip_prefix(sd, 'skinning_decoder_fwd.')
    return {'layers': convert_wn_mlp(stripped, '', n_layers + 1)}


def load_torch_checkpoint(path: str):
    """A reference .pt/.ckpt as a state dict of CPU tensors (its
    `state_dict` or `model` entry when it has one)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    for key in ('state_dict', 'model'):
        if key in ckpt:
            return dict(ckpt[key])
    return dict(ckpt)


# --------------------------------------------------------- save / resume
def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tree(v) for v in tree)
    return tree.detach().cpu().clone()


def _copy_into(dst, src, path=()):
    """Copy the saved tree `src` into the live tree `dst` leaf by leaf (in
    place, so that the optimizer keeps its references)."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f'checkpoint keys at {path}: {sorted(src)} '
                             f'!= {sorted(dst)}')
        for k in dst:
            _copy_into(dst[k], src[k], path + (k,))
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f'checkpoint list length at {path}')
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, path + (i,))
    else:
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f'checkpoint shape at {path}: '
                             f'{tuple(src.shape)} != {tuple(dst.shape)}')
        with torch.no_grad():
            dst.copy_(src)


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f'step_{step:08d}')


def save_checkpoint(ckpt_dir: str, step: int, state):
    """Save a `TrainState` (params, optimizer, step), or a parameters-only
    `{'params': tree}` (what `cli/convert_checkpoint.py` writes), under
    `step_<step>/` and point `LAST` at it; returns the directory. In a
    group of several processes every rank calls it: rank 0 writes its
    replica, then all meet at a barrier."""
    from arah_tpu_torch.parallel import distributed
    path = step_dir(ckpt_dir, step)
    if distributed.process_index() == 0:
        _write_checkpoint(ckpt_dir, step, path, state)
    distributed.sync_global_devices('save_checkpoint')
    return path


def _write_checkpoint(ckpt_dir: str, step: int, path: str, state):
    os.makedirs(path, exist_ok=True)
    if isinstance(state, dict):
        if set(state) != {'params'}:
            raise ValueError(f'save_checkpoint: a dict state holds '
                             f"'params' only, not {sorted(state)}")
        blob = {'params': _cpu_tree(state['params']), 'step': step}
    else:
        opt = state.optimizer
        blob = {'params': _cpu_tree(state.params), 'step': int(state.step),
                'optimizer': opt.adam.state_dict()}
        if opt.schedule is not None:
            blob['schedule'] = opt.schedule.state_dict()
    tmp = os.path.join(path, STATE_FILE + '.tmp')
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(ckpt_dir, 'LAST'), 'w') as f:
        f.write(str(step))


def latest_step(ckpt_dir: str):
    p = os.path.join(ckpt_dir, 'LAST')
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_checkpoint(ckpt_dir: str, target, step: int | None = None):
    """Restore into `target`, a `TrainState` whose params are live: the
    saved parameters are copied into its leaves and, unless its optimizer
    is None (evaluation), the Adam state (and schedule) loaded into its
    optimizer; a parameters-only checkpoint fills the parameters alone.
    Returns (state, step), or (None, None) without a checkpoint. The file
    loads straight to the parameters' device (each rank's own)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    device = next(leaf for _, leaf in tree_leaves_with_path(target.params)
                  if torch.is_tensor(leaf)).device
    blob = torch.load(os.path.join(step_dir(ckpt_dir, step), STATE_FILE),
                      map_location=device, weights_only=False)
    _copy_into(target.params, blob['params'])
    if 'optimizer' not in blob:
        # parameters only (a converted reference checkpoint): the
        # optimizer state and the step keep their initial values, as in
        # JAX's restore
        return target, step
    for st in blob['optimizer']['state'].values():
        # Adam keeps its step counts on the host
        if torch.is_tensor(st.get('step')):
            st['step'] = st['step'].cpu()
    opt = target.optimizer
    if opt is not None:
        opt.adam.load_state_dict(blob['optimizer'])
        if opt.schedule is not None and 'schedule' in blob:
            opt.schedule.load_state_dict(blob['schedule'])
    return target._replace(step=blob['step']), step
