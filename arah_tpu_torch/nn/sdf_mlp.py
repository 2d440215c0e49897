"""IDR-style geometric-init SDF MLP (the reference's `geo_mlp` decoder
variant). Port of `arah_tpu/nn/sdf_mlp.py`: a softplus(beta=100) MLP on
NeRF-encoded points with the encoded input re-injected at the skip
layers (scaled by 1/sqrt(2)), the 144-d hierarchical pose code
concatenated at the `cond_in` layers, geometric (SAL) initialisation,
weight norm, and the sdf channel rescaled by 1/scale.

No shipped config runs it (they use the `hyper_bvp` hypernetwork), in
JAX either; it completes the reference's decoder registry. A JAX tree of
its parameters moves across with `convert.params_from_jax`, the layout
being the same key for key."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arah_tpu_torch.core.embedder import embedding_dim, positional_encoding
from arah_tpu_torch.nn.layers import (geometric_init_mlp, linear,
                                      softplus100, wn_linear)
from arah_tpu_torch.nn.pose_encoder import (init_pose_encoder,
                                            pose_encoder_apply)


class SdfMlpConfig(NamedTuple):
    d_in: int = 3
    d_out: int = 257            # 1 sdf + 256 feature
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: tuple = (4,)
    cond_in: tuple = (0,)
    cond_dim: int = 144
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    inside_outside: bool = False
    weight_norm: bool = True


def _dims(cfg: SdfMlpConfig):
    d0 = cfg.d_in if cfg.multires == 0 \
        else embedding_dim(cfg.multires, cfg.d_in)
    return [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]


def init_sdf_mlp(gen: torch.Generator, cfg: SdfMlpConfig, device='cpu'):
    """{'layers': the geometric-init MLP, 'pose_encoder': ...}, drawn
    from `gen` (a CPU generator; not JAX's numbers, JAX's law)."""
    layers = geometric_init_mlp(
        gen, _dims(cfg), skip_in=cfg.skip_in, cond_in=cfg.cond_in,
        cond_dim=cfg.cond_dim, bias=cfg.bias,
        inside_outside=cfg.inside_outside, multires=cfg.multires,
        weight_norm=cfg.weight_norm, device=device)
    return {'layers': layers,
            'pose_encoder': init_pose_encoder(gen, device=device)}


def sdf_mlp_apply(params, cfg: SdfMlpConfig, coords: torch.Tensor,
                  rots: torch.Tensor, Jtrs: torch.Tensor) -> torch.Tensor:
    """coords (N, 3), rots (1, 24, 9), Jtrs (1, 24, 3) -> (N, d_out),
    the sdf channel rescaled by 1/scale."""
    lin = wn_linear if cfg.weight_norm else linear
    cond = pose_encoder_apply(params['pose_encoder'], rots, Jtrs,
                              rel_joints=False)[0]
    x0 = positional_encoding(coords * cfg.scale, cfg.multires)
    x = x0
    n = cfg.n_layers + 1
    for l in range(n):
        if l in cfg.cond_in:
            x = torch.cat([x, cond.expand(x.shape[:-1] + cond.shape[-1:])],
                          dim=-1)
        if l in cfg.skip_in:
            x = torch.cat([x, x0], dim=-1) / math.sqrt(2.0)
        x = lin(params['layers'][l], x)
        if l < n - 1:
            x = softplus100(x)
    return torch.cat([x[..., :1] / cfg.scale, x[..., 1:]], dim=-1)
