"""Colour-MLP forward: kernel D and its plain version.

`color_mlp_fused` launches the CUDA kernel (csrc/color.cu, the port of
`arah_tpu/ops/pallas/color_kernel.py:_color_fwd_pallas` /
`color_mlp_fused`) for CUDA tensors and computes `color_mlp_plain` — the
concat path of `arah_tpu/nn/color.py:color_apply` — for CPU tensors.

Column layout (as in `color_apply`): x0 = [small (S) | feats (F) | pose
(P, one row broadcast)], and a skip layer's input is [x0 | x].
"""
from __future__ import annotations

import torch

from arah_tpu_torch.nn.layers import mm_t
from arah_tpu_torch.ops import _build


def color_mlp_plain(weights, biases, small, feats, pose, skips: tuple,
                    squeeze_out: bool = True, bf16: bool = False):
    """Plain version of kernel D: build x0 by concatenation and run the
    ReLU MLP (bf16: operands rounded to bf16, f32 accumulation)."""
    n = small.shape[0]
    parts = [small.float(), feats.float()]
    if pose is not None:
        parts.append(pose.reshape(1, -1).float().expand(n, -1))
    if bf16:
        parts = [p.bfloat16() for p in parts]
    x0 = torch.cat(parts, dim=-1)
    x = x0
    L = len(weights)
    for l in range(L):
        if l in skips:
            x = torch.cat([x0, x.to(x0.dtype)], dim=-1)
        x = mm_t(x, weights[l], bf16) + biases[l]
        if l < L - 1:
            x = torch.relu(x)
            if bf16:
                x = x.bfloat16()
    return torch.sigmoid(x) if squeeze_out else x


_KIND = {'x': 0, 'small': 1, 'feats': 2, 'pose': 3}


def color_mlp_fused(weights, biases, small, feats, pose, skips: tuple,
                    squeeze_out: bool = True, bf16: bool = False):
    """Kernel D: rgb (N, out) of the colour MLP. weights: L dense (out,
    in) matrices (weight norm applied) with columns in the x0/skip
    layout above; small (N, S) f32; feats (N, F) f32 or bf16; pose
    (1, P) or None."""
    if not small.is_cuda:
        return color_mlp_plain(weights, biases, small, feats, pose, skips,
                               squeeze_out, bf16)
    n, S = small.shape
    F = feats.shape[1]
    P = 0 if pose is None else pose.shape[-1]
    d0 = S + F + P
    L = len(weights)
    outs = [w.shape[0] for w in weights]
    if L > 8 or max(outs[:-1]) > 256 or 32 * outs[-1] > 256:
        raise ValueError(f'color kernel: unsupported MLP widths {outs}')
    _build.require(small, 'small', torch.float32, (n, S))
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'feats: expected f32 or bf16, got {feats.dtype}')
    _build.require(feats, 'feats', feats.dtype, (n, F))
    pose_t = None
    if P:
        pose_t = pose.reshape(P).float().contiguous()

    pack = _build.ParamPack()
    n_comp, kind, width, w_off = [], [], [], []
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
        n_comp.append(len(comps))
        kk, ww, oo = [], [], []
        for name, start, wd in comps:
            kk.append(_KIND[name])
            ww.append(wd)
            oo.append(pack.put(w[:, start:start + wd].T.contiguous()))
        kind.append(kk + [0] * (4 - len(kk)))
        width.append(ww + [0] * (4 - len(ww)))
        w_off.append(oo + [0] * (4 - len(oo)))
    b_off = [pack.put(b) for b in biases]
    params = pack.tensor()

    I8, L8 = _build._I * 8, _build.ctypes.c_longlong * 8
    I4x8 = (_build._I * 4) * 8
    L4x8 = (_build.ctypes.c_longlong * 4) * 8
    pad = 8 - L
    meta = _build.ColorMeta(
        L, S, F, P, max(outs[:-1]), int(squeeze_out), int(bf16),
        int(feats.dtype == torch.bfloat16),
        I8(*(outs + [0] * pad)), I8(*(n_comp + [0] * pad)),
        I4x8(*[(_build._I * 4)(*r) for r in kind + [[0] * 4] * pad]),
        I4x8(*[(_build._I * 4)(*r) for r in width + [[0] * 4] * pad]),
        L4x8(*[(_build.ctypes.c_longlong * 4)(*r)
               for r in w_off + [[0] * 4] * pad]),
        L8(*(b_off + [0] * pad)))
    rgb = torch.empty((n, outs[-1]), dtype=torch.float32, device=small.device)
    lib = _build.load()
    _build.check(lib.arah_color_fwd(
        small.data_ptr(), feats.data_ptr(),
        pose_t.data_ptr() if pose_t is not None else None, n,
        params.data_ptr(), meta, rgb.data_ptr(), _build.stream_ptr(small)),
        'color_fwd')
    _build.COUNTS['color_fwd'] += 1
    return rgb
