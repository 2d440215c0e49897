"""Forward-LBS skinning network (SNARF-style Deformer): a weight-normed
softplus(beta=100) MLP from normalized canonical points (3,) to 25 logits
(24 bones + the spine gate of the hierarchical softmax).
A frozen copy of the port's `nn/skinning.py`."""
from __future__ import annotations

from typing import NamedTuple

import torch

from gpubench.reference.body import hierarchical_softmax
from gpubench.reference.embedder import embedding_dim, positional_encoding
from gpubench.reference.layers import (Draws, geometric_init_mlp,
                                      init_linear, init_wn_linear, linear,
                                      softplus100, wn_linear)


class SkinningConfig(NamedTuple):
    d_in: int = 3
    d_out: int = 25
    d_hidden: int = 128
    n_layers: int = 4
    skip_in: tuple = ()
    cond_in: tuple = ()
    cond_dim: int = 0
    multires: int = 0
    bias: float = 1.0
    geometric_init: bool = False
    weight_norm: bool = True
    softmax_scale: float = 20.0   # logits * 20 before hierarchical softmax


def _dims(cfg: SkinningConfig):
    d0 = cfg.d_in if cfg.multires == 0 else embedding_dim(cfg.multires,
                                                          cfg.d_in)
    return [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]


def init_skinning(gen: Draws, cfg: SkinningConfig, device='cpu'):
    dims = _dims(cfg)
    if cfg.geometric_init:
        return {'layers': geometric_init_mlp(
            gen, dims, skip_in=cfg.skip_in, cond_in=cfg.cond_in,
            cond_dim=cfg.cond_dim, bias=cfg.bias, multires=cfg.multires,
            weight_norm=cfg.weight_norm, device=device)}
    layers = []
    for l in range(len(dims) - 1):
        in_dim = dims[l] + (cfg.cond_dim if l in cfg.cond_in else 0)
        out_dim = dims[l + 1] - (dims[0] if l + 1 in cfg.skip_in else 0)
        init = init_wn_linear if cfg.weight_norm else init_linear
        layers.append(init(gen, in_dim, out_dim, device=device))
    return {'layers': layers}


def skinning_logits(params, cfg: SkinningConfig, p: torch.Tensor,
                    cond: torch.Tensor | None = None) -> torch.Tensor:
    """Raw network output (..., 25) at normalized canonical points."""
    lin = wn_linear if cfg.weight_norm else linear
    x0 = positional_encoding(p, cfg.multires) if cfg.multires > 0 else p
    x = x0
    n = cfg.n_layers + 1
    for l in range(n):
        if l in cfg.cond_in and cond is not None:
            x = torch.cat([x, cond.expand(x.shape[:-1] + cond.shape[-1:])],
                          dim=-1)
        if l in cfg.skip_in:
            x = torch.cat([x, x0], dim=-1)
        x = lin(params['layers'][l], x)
        if l < n - 1:
            x = softplus100(x)
    return x


def skinning_weights(params, cfg: SkinningConfig, p: torch.Tensor,
                     cond: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized (..., 24) skinning weights: plain softmax for 24-channel
    nets, hierarchical softmax of logits*20 for 25-channel ones."""
    logits = skinning_logits(params, cfg, p, cond)
    if cfg.d_out == 24:
        return torch.softmax(logits, dim=-1)
    return hierarchical_softmax(logits * cfg.softmax_scale)
