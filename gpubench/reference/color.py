"""IDR-style rendering (colour) network of the plain reference: a
weight-normed ReLU MLP over [points, PE(view dirs), normals, SDF
features, pose feature] with a skip re-injecting the input and a sigmoid
output, in its concatenated form (a frozen copy of the port's
`nn/color.py` and of the plain version of its colour op)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from gpubench.reference.embedder import embedding_dim, positional_encoding
from gpubench.reference.layers import Draws, init_wn_linear, mm_t, wn_weight
from gpubench.reference.precision import rounder
from gpubench.reference.pose_encoder import (init_pose_encoder,
                                            pose_encoder_apply)


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


def init_color(gen: Draws, cfg: ColorConfig, device='cpu'):
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
    small = torch.cat([a.float() for a in narrow], dim=-1)
    weights = [wn_weight(lyr) for lyr in params['layers']]
    biases = [lyr['b'] for lyr in params['layers']]
    return color_mlp(weights, biases, small, sdf_feature, pose_feature,
                     skips=tuple(cfg.skips), squeeze_out=cfg.squeeze_out,
                     bf16=bf16)


def color_mlp(weights, biases, small, feats, pose, skips: tuple,
              squeeze_out: bool = True, bf16: bool = False):
    """rgb (N, out) of the ReLU MLP over x0 = [small | feats | pose],
    a skip layer's input [x0 | x]; differentiable, its backward the
    explicit one of `color_mlp_bwd`."""
    return _ColorMLP.apply(tuple(skips), bool(squeeze_out), bool(bf16),
                           len(weights), small, feats, pose, *weights,
                           *biases)


def color_mlp_fwd(weights, biases, small, feats, pose, skips: tuple,
                  squeeze_out: bool = True, bf16: bool = False):
    """The forward, x0 by concatenation (operands rounded as
    `precision.rounder` says, f32 sums)."""
    n = small.shape[0]
    parts = [small.float(), feats.float()]
    if pose is not None:
        parts.append(pose.reshape(1, -1).float().expand(n, -1))
    x0 = torch.cat(parts, dim=-1)
    x = x0
    L = len(weights)
    for l in range(L):
        if l in skips:
            x = torch.cat([x0, x], dim=-1)
        x = mm_t(x, weights[l], bf16) + biases[l]
        if l < L - 1:
            x = torch.relu(x)
    return torch.sigmoid(x) if squeeze_out else x


def _parts(weights, S: int, F: int, P: int, skips: tuple):
    """Per layer, its input parts (kind, first column, width): x, small,
    feats, pose."""
    d0 = S + F + P
    out = []
    for l, w in enumerate(weights):
        if l == 0:
            comps = [('small', 0, S), ('feats', S, F)]
        elif l in skips:
            comps = [('x', d0, w.shape[1] - d0), ('small', 0, S),
                     ('feats', S, F)]
        else:
            comps = [('x', 0, w.shape[1])]
        if P and (l == 0 or l in skips):
            comps.append(('pose', S + F, P))
        out.append(comps)
    return out


# under bf16 the pose gradient rounds the column sums of delta over each
# group of BWD_TILE points before its product
BWD_TILE = 16


def color_mlp_bwd(weights, biases, small, feats, pose, g_rgb,
                  skips: tuple, squeeze_out: bool = True,
                  bf16: bool = False):
    """The explicit backward of `color_mlp_fwd`, every product's operands
    rounded as the forward's: (dW (L full (out, in)), db (L), dsmall (N,
    S), dfeats (N, F), dpose (1, P) or None)."""
    r = rounder(bf16)
    n, S = small.shape
    F = feats.shape[1]
    P = 0 if pose is None else pose.shape[-1]
    pose = None if pose is None else pose.reshape(1, P).float()
    inputs = {'small': small.float(), 'feats': feats.float()}
    parts = _parts(weights, S, F, P, skips)
    L = len(weights)
    xs, x = [None] * L, None
    for l in range(L):
        z = biases[l]
        for name, st, wd in parts[l]:
            a = x if name == 'x' else (pose if name == 'pose'
                                       else inputs[name])
            z = z + r(a) @ r(weights[l][:, st:st + wd]).T
        if l < L - 1:
            x = torch.relu(z)
            xs[l + 1] = x
    if squeeze_out:
        rgb = torch.sigmoid(z)
        delta = g_rgb * rgb * (1.0 - rgb)
    else:
        delta = g_rgb
    pad = (-n) % BWD_TILE
    dW, db = [None] * L, [None] * L
    dsmall = torch.zeros_like(inputs['small'])
    dfeats = torch.zeros_like(inputs['feats'])
    dpose = None if pose is None else torch.zeros_like(pose)
    for l in range(L - 1, -1, -1):
        db[l] = delta.sum(dim=0)
        dWl = torch.zeros_like(weights[l])
        dx = None
        for name, st, wd in parts[l]:
            wo = weights[l][:, st:st + wd]
            if name == 'pose':
                cs = torch.nn.functional.pad(delta, (0, 0, 0, pad)).reshape(
                    -1, BWD_TILE, delta.shape[1]).sum(dim=1)
                dWl[:, st:st + wd] = r(cs).T @ r(pose).expand(
                    cs.shape[0], -1)
                dpose = dpose + (r(cs) @ r(wo)).sum(dim=0, keepdim=True)
                continue
            a = xs[l] if name == 'x' else inputs[name]
            dWl[:, st:st + wd] = r(delta).T @ r(a)
            da = r(delta) @ r(wo)
            if name == 'x':
                dx = da
            elif name == 'small':
                dsmall = dsmall + da
            else:
                dfeats = dfeats + da
        dW[l] = dWl
        if l > 0:
            delta = dx * (xs[l] > 0)
    return dW, db, dsmall, dfeats, dpose


class _ColorMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, skips, squeeze_out, bf16, n_layers, small, feats, pose,
                *wb):
        ctx.cfg = (skips, squeeze_out, bf16, n_layers)
        ctx.save_for_backward(small, feats, pose, *wb)
        return color_mlp_fwd(wb[:n_layers], wb[n_layers:], small, feats,
                             pose, skips, squeeze_out, bf16)

    @staticmethod
    def backward(ctx, g_rgb):
        skips, squeeze_out, bf16, L = ctx.cfg
        small, feats, pose, *wb = ctx.saved_tensors
        dW, db, dsmall, dfeats, dpose = color_mlp_bwd(
            wb[:L], wb[L:], small, feats, pose, g_rgb, skips, squeeze_out,
            bf16)
        if dpose is not None:
            dpose = dpose.reshape(pose.shape)
        return (None, None, None, None, dsmall, dfeats.to(feats.dtype),
                dpose, *dW, *db)
