"""Hypernetwork that emits per-frame SIREN SDF weights from body pose,
plus the FiLM mapping network. A frozen copy of the port's `nn/hypernet.py`:

  pose (24x9 rots, 24x3 Jtrs) -> hierarchical pose encoder -> 144-d cond
    -> per-SIREN-layer hyper-MLP (LayerNorm+ReLU hidden, zero-init last
       layer, + frozen `hypo_init`) -> GeneratedMLP weights
  latent (128-d) -> mapping network -> per-layer (freq, phase)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gpubench.reference.layers import Draws, init_linear, linear
from gpubench.reference.pose_encoder import (init_pose_encoder,
                                            pose_encoder_apply)
from gpubench.reference.siren import GeneratedMLP


def init_layer_norm(dim: int, device='cpu'):
    return {'gamma': torch.ones((dim,), device=device),
            'beta': torch.zeros((dim,), device=device)}


def layer_norm(params, x, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params['gamma'] + params['beta']


def init_fc_block(gen, in_features, hidden, num_hidden_layers, out_features,
                  zero_last: bool = False, device='cpu'):
    """[FCLayer(in->h), FCLayer(h->h) x num_hidden_layers, Linear(h->out)],
    kaiming_relu weights; the last linear may be zero-init."""
    layers = []
    d = in_features
    for _ in range(num_hidden_layers + 1):
        layers.append({'lin': init_linear(gen, d, hidden, 'kaiming_relu',
                                          device),
                       'ln': init_layer_norm(hidden, device)})
        d = hidden
    last = init_linear(gen, d, out_features,
                       'zeros' if zero_last else 'kaiming_relu', device)
    return {'hidden': layers, 'last': last}


def fc_block_apply(params, x):
    for lyr in params['hidden']:
        x = torch.relu(layer_norm(lyr['ln'], linear(lyr['lin'], x)))
    return linear(params['last'], x)


def init_mapping_network(gen, z_dim=128, hidden=256, out_dim=None,
                         pretrained_siren: bool = True, device='cpu'):
    """4 linears with LeakyReLU(0.2); with pretrained_siren the last layer
    is zero-weight with bias [1...1, 0...0] (identity FiLM)."""
    lins = [init_linear(gen, z_dim, hidden, 'kaiming_leaky02', device),
            init_linear(gen, hidden, hidden, 'kaiming_leaky02', device),
            init_linear(gen, hidden, hidden, 'kaiming_leaky02', device)]
    last = init_linear(gen, hidden, out_dim, 'kaiming_leaky02', device)
    if pretrained_siren:
        b = torch.cat([torch.ones((out_dim // 2,)),
                       torch.zeros((out_dim - out_dim // 2,))]).to(device)
        last = {'w': torch.zeros_like(last['w']), 'b': b}
    else:
        last = {'w': last['w'] * 0.25, 'b': last['b']}
    return {'lins': lins, 'last': last}


def mapping_network_apply(params, z):
    x = z
    for lin in params['lins']:
        x = torch.nn.functional.leaky_relu(linear(lin, x), 0.2)
    out = linear(params['last'], x)
    half = out.shape[-1] // 2
    return out[..., :half], out[..., half:]


class HypernetConfig(NamedTuple):
    in_features: int = 3
    out_features: int = 1
    hidden_features: int = 256
    num_hidden_layers: int = 5   # SIREN hidden layers (total L = nhl + 2)
    hyper_in_ch: int = 144       # pose-encoder output dim
    hyper_hidden_ch: int = 256
    hyper_num_hidden_layers: int = 1
    use_film: bool = True
    hierarchical_pose: bool = True
    rel_joints: bool = False
    latent_dim: int = 128


def siren_layer_dims(cfg: HypernetConfig):
    dims = [(cfg.in_features, cfg.hidden_features)]
    for _ in range(cfg.num_hidden_layers):
        dims.append((cfg.hidden_features, cfg.hidden_features))
    dims.append((cfg.hidden_features, cfg.out_features))
    return dims


def init_hypernet(gen: Draws, cfg: HypernetConfig, device='cpu'):
    """Hyper-MLPs per SIREN layer plus sine-initialised `hypo_init` base
    weights, the FiLM mapping network and the pose encoder."""
    dims = siren_layer_dims(cfg)
    hyper_layers, hypo_init = [], []
    for i, (d_in, d_out) in enumerate(dims):
        hyper_layers.append(init_fc_block(
            gen, cfg.hyper_in_ch, cfg.hyper_hidden_ch,
            cfg.hyper_num_hidden_layers, d_in * d_out + d_out,
            zero_last=True, device=device))
        base = init_linear(gen, d_in, d_out,
                           'sine_first' if i == 0 else 'sine', device)
        hypo_init.append(torch.cat([base['w'].reshape(-1), base['b']]))
    params = {'hyper_layers': hyper_layers, 'hypo_init': hypo_init}
    if cfg.use_film:
        n_mod = (len(dims) - 1) * cfg.hidden_features
        params['mapping'] = init_mapping_network(
            gen, cfg.latent_dim, 256, n_mod * 2, pretrained_siren=True,
            device=device)
    if cfg.hierarchical_pose:
        params['pose_encoder'] = init_pose_encoder(gen, device=device)
    return params


def hypernet_cond(params, cfg: HypernetConfig, rots, Jtrs):
    """Pose conditioning vector (B, 144)."""
    return pose_encoder_apply(params['pose_encoder'], rots, Jtrs,
                              rel_joints=cfg.rel_joints)


def hypernet_generate(params, cfg: HypernetConfig, cond: torch.Tensor,
                      latent: torch.Tensor | None = None) -> GeneratedMLP:
    """SIREN weights for one conditioning vector (144,): hyper-MLP output
    + hypo_init, split into (out, in) weight and (out,) bias."""
    dims = siren_layer_dims(cfg)
    weights, biases = [], []
    for i, (d_in, d_out) in enumerate(dims):
        flat = fc_block_apply(params['hyper_layers'][i], cond) \
            + params['hypo_init'][i]
        weights.append(flat[..., :d_in * d_out].reshape(
            flat.shape[:-1] + (d_out, d_in)))
        biases.append(flat[..., d_in * d_out:d_in * d_out + d_out])

    freqs, phases = (), ()
    if cfg.use_film and latent is not None:
        f, p = mapping_network_apply(params['mapping'], latent)
        h = cfg.hidden_features
        n_mod = len(dims) - 1
        freqs = tuple(f[..., i * h:(i + 1) * h] for i in range(n_mod))
        phases = tuple(p[..., i * h:(i + 1) * h] for i in range(n_mod))
    return GeneratedMLP(tuple(weights), tuple(biases), freqs, phases)


def hypernet_flat_params(gen: GeneratedMLP):
    """Per-layer flattened weight vectors (biases excluded)."""
    return [w.reshape(w.shape[:-2] + (-1,)) for w in gen.weights]
