"""IDR-style rendering (colour) network: a weight-normed ReLU MLP over
[points, PE(view dirs), normals, SDF features, pose feature] with a skip
re-injecting the input and a sigmoid output. Port of
`arah_tpu/nn/color.py`; the MLP itself runs in `ops/color.py` (kernel D,
or its plain concat version)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from arah_tpu_torch.core.embedder import embedding_dim, positional_encoding
from arah_tpu_torch.nn.layers import init_wn_linear, wn_weight
from arah_tpu_torch.nn.pose_encoder import (init_pose_encoder,
                                            pose_encoder_apply)
from arah_tpu_torch.ops.color import color_mlp_fused, color_mlp_plain


class ColorConfig(NamedTuple):
    d_feature: int = 384          # 256 sdf feature + pose feature width
    mode: str = 'idr'             # idr | no_view_dir | no_normal
    d_in: int = 9
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 5
    multires: int = 0             # PE on points
    multires_view: int = 4        # PE on view dirs
    skips: tuple = (3,)
    squeeze_out: bool = True
    pose_encoder: str | None = 'latent'  # None|leap|root|latent|hybrid
    rel_joints: bool = True
    # the JAX package's fold_input is a scheduling A/B of the same MLP
    # (per-component partial matmuls instead of the input concat); the
    # port's plain path is the concat form either way
    fold_input: bool = False
    # True: the colour MLP runs in kernel D (ops/color.py) — the CUDA
    # kernel on a CUDA tensor, its plain version on a CPU tensor.
    # False: the plain concat path on any device.
    use_pallas: bool = True
    pallas_tile: int = 1024
    pallas_tile_bwd: int = 512


def _dims(cfg: ColorConfig):
    d0 = cfg.d_in + cfg.d_feature
    if cfg.multires > 0:
        d0 += embedding_dim(cfg.multires, 3) - 3
    if cfg.multires_view > 0:
        d0 += embedding_dim(cfg.multires_view, 3) - 3
    dims = [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]
    for skip in cfg.skips:
        dims[skip] = dims[skip] // 2 + dims[0]
    return dims


def init_color(gen: torch.Generator, cfg: ColorConfig, device='cpu'):
    dims = _dims(cfg)
    layers = []
    for l in range(len(dims) - 1):
        out_dim = dims[l + 1] - (dims[0] if l + 1 in cfg.skips else 0)
        layers.append(init_wn_linear(gen, dims[l], out_dim, device=device))
    params = {'layers': layers}
    if cfg.pose_encoder == 'leap':
        params['pose_encoder'] = init_pose_encoder(gen, device=device)
    return params


def color_pose_feature(params, cfg: ColorConfig, pose_cond: dict):
    """The (1, F_pose) pose feature from the pose_cond dict."""
    if cfg.pose_encoder == 'leap':
        return pose_encoder_apply(
            params['pose_encoder'], pose_cond['rots_full'][:1],
            pose_cond['Jtrs_posed'][:1], rel_joints=cfg.rel_joints)
    if cfg.pose_encoder in ('root', 'hybrid'):
        rot = pose_cond['rots_full'][:1, 0].reshape(1, 9)
        trans = pose_cond['Jtrs_posed'][:1, 0].reshape(1, 3)
        if 'rot_noise' in pose_cond and 'trans_noise' in pose_cond:
            rot = rot + pose_cond['rot_noise']
            trans = trans + pose_cond['trans_noise']
        feat = torch.cat([rot, trans], dim=-1)
        if cfg.pose_encoder == 'hybrid':
            feat = torch.cat([feat, pose_cond['latent_code']], dim=-1)
        return feat
    if cfg.pose_encoder == 'latent':
        return pose_cond['latent_code']
    return None


def color_apply(params, cfg: ColorConfig, points: torch.Tensor,
                normals: torch.Tensor, view_dirs: torch.Tensor,
                sdf_feature: torch.Tensor,
                pose_feature: torch.Tensor | None,
                bf16: bool = False) -> torch.Tensor:
    """RGB at points; point-shaped args are (N, .), pose_feature (1, F) is
    broadcast across points. bf16: see `layers.mm_t`."""
    if cfg.multires > 0:
        points = positional_encoding(points, cfg.multires)
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    if cfg.mode == 'idr':
        narrow = [points, view_dirs, normals]
    elif cfg.mode == 'no_view_dir':
        narrow = [points, normals]
    elif cfg.mode == 'no_normal':
        narrow = [points, view_dirs]
    else:
        raise ValueError(cfg.mode)
    small = torch.cat([a.float() for a in narrow], dim=-1).contiguous()
    weights = [wn_weight(lyr) for lyr in params['layers']]
    biases = [lyr['b'] for lyr in params['layers']]
    mlp = color_mlp_fused if cfg.use_pallas else color_mlp_plain
    return mlp(weights, biases, small, sdf_feature, pose_feature,
               skips=tuple(cfg.skips), squeeze_out=cfg.squeeze_out,
               bf16=bf16)


def feature_width(pose_encoder: str | None, latent_dim: int = 128,
                  sdf_feature_dim: int = 256) -> int:
    """SDF-feature + pose-feature width."""
    return sdf_feature_dim + {None: 0, 'leap': 144, 'root': 12,
                              'latent': latent_dim,
                              'hybrid': 12 + latent_dim}[pose_encoder]
