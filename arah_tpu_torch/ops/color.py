"""The colour MLP and its gradient: kernels D and I and their plain
versions, joined as the D -> I op.

`color_mlp_fused` is a `torch.autograd.Function`. Its forward launches
kernel D (csrc/color.cu, the port of `arah_tpu/ops/pallas/color_kernel.py:
_color_fwd_pallas`) for CUDA tensors and computes `color_mlp_plain` — the
concat path of `arah_tpu/nn/color.py:color_apply` — for CPU tensors. Its
backward launches kernel I (the port of `_color_bwd_pallas`, in the same
source) or computes `color_mlp_bwd_plain`, the explicit backward of
`_color_bwd_kernel` with its bf16 rounding points (autograd of the plain
forward would round the backward's products, which the kernel keeps in
f32). Both return dW and db for each full (out, in) matrix, dsmall,
dfeats and dpose; weight norm stays outside, in `nn/color.py`, as in JAX.

Column layout (as in `color_apply`): x0 = [small (S) | feats (F) | pose
(P, one row broadcast)], and a skip layer's input is [x0 | x].
"""
from __future__ import annotations

import torch

from arah_tpu_torch.nn.layers import mm_t
from arah_tpu_torch.ops import _build
from arah_tpu_torch.utils import trace

# under bf16 the pose gradient rounds the column sum of delta over each
# group of BWD_TILE points (as the Pallas kernel rounds each grid tile's;
# kernel I's 32-point tile sums its two halves apart, CB_HALF in
# csrc/color.cu), and the plain backward groups its rows the same way
BWD_TILE = 16
# kernel I's points per workspace pass (CB_CHUNK in csrc/color.cu)
CB_CHUNK = 65536


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


def _parts(weights, S: int, F: int, P: int, skips: tuple):
    """Per layer, its input parts (kind, first column, width) in the
    order of `_recompute_chain`: x, small, feats, pose."""
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


def color_mlp_bwd_plain(weights, biases, small, feats, pose, g_rgb,
                        skips: tuple, squeeze_out: bool = True,
                        bf16: bool = False):
    """Plain version of kernel I. Returns (dW (L full (out, in)), db (L),
    dsmall (N, S), dfeats (N, F), dpose (1, P) or None)."""
    r = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
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
                    -1, BWD_TILE, delta.shape[1]).sum(dim=1)   # tile sums
                dWl[:, st:st + wd] = (r(cs).T @ r(pose).expand(
                    cs.shape[0], -1))
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


def _pad32(k: int) -> int:
    return -(-k // 32) * 32


def _bf16_blocks(parts):
    """Kernel I's tensor-core weight blocks, in pack order: (layer, part
    index, first column, width) of every x, small and feats part of the
    hidden layers (the last layer and the pose parts stay on the CUDA
    cores)."""
    return [(l, c, st, wd) for l, comps in enumerate(parts[:-1])
            for c, (name, st, wd) in enumerate(comps) if name != 'pose']


def pack_color_bf16(weights, S: int, F: int, P: int, skips: tuple):
    """The tensor-core operands of kernels D and I under bf16: for each
    block of `_bf16_blocks`, the part's weights (out, width) rounded to
    bf16 with the width zero-padded to the next multiple of 32 (D and I
    read this one), then their transpose (padded width, out; I only); one
    flat bf16 tensor. The offsets are ColorMeta's wf_off and wb_off
    (`_pack`)."""
    outs = [w.shape[0] for w in weights]
    if F % 32 or any(o % 32 for o in outs[:-1]):
        raise ValueError('color kernels: their bf16 tensor-core products '
                         'take feature and hidden widths divisible by 32, '
                         f'not F={F}, widths {outs}')
    out = []
    for l, _, st, wd in _bf16_blocks(_parts(weights, S, F, P, skips)):
        w = torch.nn.functional.pad(
            weights[l].detach()[:, st:st + wd].bfloat16(),
            (0, _pad32(wd) - wd))
        out += [w.reshape(-1), w.T.contiguous().reshape(-1)]
    if not out:
        return torch.empty((0,), dtype=torch.bfloat16,
                           device=weights[0].device)
    return torch.cat(out)


def _pack(weights, biases, S: int, F: int, P: int, skips: tuple,
          squeeze_out: bool, bf16: bool, feats_bf16: bool):
    """(parameter buffer, ColorMeta, gradient-buffer size) for kernels D
    and I; the gradient buffer holds each layer's full (out, in) dW, then
    the db vectors, then dpose, then kernel I's pose sums S_l."""
    L = len(weights)
    outs = [w.shape[0] for w in weights]
    if L > 8 or max(outs[:-1]) > 256 or 32 * outs[-1] > 256:
        raise ValueError(f'color kernels: unsupported MLP widths {outs}')
    # every use of a weight is a dot operand: under bf16 they are stored
    # rounded (kernel I relies on it)
    weights = [w.detach().bfloat16().float() if bf16 else w.detach()
               for w in weights]
    pack = _build.ParamPack()
    n_comp, kind, width, w_off, start = [], [], [], [], []
    parts = _parts(weights, S, F, P, skips)
    for l, comps in enumerate(parts):
        w = weights[l]
        n_comp.append(len(comps))
        kind.append([_KIND[c[0]] for c in comps] + [0] * (4 - len(comps)))
        width.append([c[2] for c in comps] + [0] * (4 - len(comps)))
        start.append([c[1] for c in comps] + [0] * (4 - len(comps)))
        w_off.append([pack.put(w[:, st:st + wd].T.contiguous())
                      for _, st, wd in comps] + [0] * (4 - len(comps)))
    b_off = [pack.put(b.detach()) for b in biases]
    wo_off = [pack.put(w) for w in weights]
    g_off, gb_off, size = [], [], 0
    for w in weights:
        g_off.append(size)
        size += w.numel()
    for b in biases:
        gb_off.append(size)
        size += b.numel()
    gpose_off = size
    size += P
    # S_l, the sum of the rounded tile colsums of each layer with a pose
    # part (kernel I's epilogue makes the pose gradients from it)
    gs_off = []
    for w, comps in zip(weights, parts):
        gs_off.append(size if any(c[0] == 'pose' for c in comps) else 0)
        size += w.shape[0] if gs_off[-1] else 0
    # kernel I's workspace columns a point: every layer's delta, then the
    # x input of every layer after the first
    wd_off, wx_off, cols = [], [], 0
    for w in weights:
        wd_off.append(cols)
        cols += w.shape[0]
    for l in range(L):
        wx_off.append(cols if l > 0 else 0)
        cols += outs[l - 1] if l > 0 else 0
    # the bf16 weight blocks of D and I (pack_color_bf16), element offsets
    wf_off = [[0] * 4 for _ in range(L)]
    wb_off = [[0] * 4 for _ in range(L)]
    off = 0
    for l, c, _, wd in _bf16_blocks(parts):
        wf_off[l][c] = off
        wb_off[l][c] = off + outs[l] * _pad32(wd)
        off += 2 * outs[l] * _pad32(wd)

    I8, L8 = _build._I * 8, _build.ctypes.c_longlong * 8
    I4x8 = (_build._I * 4) * 8
    L4x8 = (_build.ctypes.c_longlong * 4) * 8
    pad = 8 - L

    def i4x8(rows):
        return I4x8(*[(_build._I * 4)(*r) for r in rows + [[0] * 4] * pad])

    def l4x8(rows):
        return L4x8(*[(_build.ctypes.c_longlong * 4)(*r)
                      for r in rows + [[0] * 4] * pad])
    meta = _build.ColorMeta(
        L, S, F, P, max(outs[:-1]), int(squeeze_out), int(bf16),
        int(feats_bf16), I8(*(outs + [0] * pad)), I8(*(n_comp + [0] * pad)),
        i4x8(kind), i4x8(width), l4x8(w_off),
        L8(*(b_off + [0] * pad)), i4x8(start), L8(*(wo_off + [0] * pad)),
        L8(*(g_off + [0] * pad)), L8(*(gb_off + [0] * pad)), gpose_off,
        L8(*(gs_off + [0] * pad)), I8(*(wd_off + [0] * pad)),
        I8(*(wx_off + [0] * pad)), cols, l4x8(wf_off), l4x8(wb_off))
    return pack.tensor(), meta, size


_KIND = {'x': 0, 'small': 1, 'feats': 2, 'pose': 3}


def _check_inputs(small, feats, pose):
    n, S = small.shape
    _build.require(small, 'small', torch.float32, (n, S))
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'feats: expected f32 or bf16, got {feats.dtype}')
    _build.require(feats, 'feats', feats.dtype, (n, feats.shape[1]))
    if pose is None:
        return None
    return pose.detach().reshape(-1).float().contiguous()


def color_fwd_operands(weights, biases, small, feats, pose, skips: tuple,
                       squeeze_out: bool = True, bf16: bool = False,
                       wbf=None):
    """Kernel D's operands for CUDA inputs, as `color_fwd_launch` takes
    them: (params, meta, wbf, pose row). `wbf`: under bf16,
    `pack_color_bf16` of the weights when the caller has it (built here
    otherwise)."""
    S, F = small.shape[1], feats.shape[1]
    P = 0 if pose is None else pose.shape[-1]
    pose_t = _check_inputs(small, feats, pose)
    params, meta, _ = _pack(weights, biases, S, F, P, skips, squeeze_out,
                            bf16, feats.dtype == torch.bfloat16)
    if bf16 and wbf is None:
        wbf = pack_color_bf16(weights, S, F, P, skips)
    return params, meta, wbf if bf16 else None, pose_t


def color_fwd_launch(params, meta, wbf, pose_t, small, feats):
    """Launch kernel D on `color_fwd_operands`' operands: rgb (N, out)."""
    n = small.shape[0]
    rgb = torch.empty((n, meta.out[meta.n_layers - 1]), dtype=torch.float32,
                      device=small.device)
    # scratch: the hidden layers' pose sums, computed once a call
    pose_sum = torch.empty((meta.n_layers * meta.hmax,), dtype=torch.float32,
                           device=small.device)
    lib = _build.load()
    _build.check(lib.arah_color_fwd(
        small.data_ptr(), feats.data_ptr(),
        pose_t.data_ptr() if pose_t is not None else None, n,
        params.data_ptr(), None if wbf is None else wbf.data_ptr(), meta,
        rgb.data_ptr(), pose_sum.data_ptr(), _build.stream_ptr(small)),
        'color_fwd')
    trace.COUNTS['color_fwd'] += 1
    return rgb


def color_fwd(weights, biases, small, feats, pose, skips: tuple,
              squeeze_out: bool = True, bf16: bool = False, wbf=None):
    """Kernel D: rgb (N, out) of the colour MLP (see `color_mlp_plain`).
    `wbf`: as for `color_fwd_operands`."""
    if not small.is_cuda:
        return color_mlp_plain(weights, biases, small, feats, pose, skips,
                               squeeze_out, bf16)
    return color_fwd_launch(*color_fwd_operands(
        weights, biases, small, feats, pose, skips, squeeze_out, bf16, wbf),
        small, feats)


def color_bwd(weights, biases, small, feats, pose, g_rgb, skips: tuple,
              squeeze_out: bool = True, bf16: bool = False, wbf=None):
    """Kernel I: the backward of kernel D (see `color_mlp_bwd_plain`).
    `wbf`: as for `color_fwd_operands`."""
    if not small.is_cuda:
        return color_mlp_bwd_plain(weights, biases, small, feats, pose, g_rgb,
                                   skips, squeeze_out, bf16)
    return color_bwd_rows(weights, biases, small, feats, pose, g_rgb, skips,
                          squeeze_out, bf16, wbf)[0]


def color_bwd_rows(weights, biases, small, feats, pose, g_rgb, skips: tuple,
                   squeeze_out: bool = True, bf16: bool = False, wbf=None):
    """Kernel I on CUDA tensors: (`color_bwd`'s result, deltas, xs) with
    the kernel's own per-point rows of its last chunk of CB_CHUNK points
    (all of them for n <= CB_CHUNK), in f32: deltas[l] (n, out_l) is the
    delta of layer l as it went into the products (rounded to bf16 under
    bf16), xs[l] (n, out_{l-1}) the recomputed x input of layer l >= 1
    (xs[0] is None), as it went into the products and the ReLU mask."""
    n, S = small.shape
    F = feats.shape[1]
    P = 0 if pose is None else pose.shape[-1]
    pose_t = _check_inputs(small, feats, pose)
    g_rgb = g_rgb.detach().float().contiguous()
    _build.require(g_rgb, 'g_rgb', torch.float32, (n, weights[-1].shape[0]))
    # the weight-gradient reduction reads the features as f32
    feats = feats.float().contiguous()
    params, meta, size = _pack(weights, biases, S, F, P, skips, squeeze_out,
                               bf16, False)
    if not bf16:
        wbf = None
    elif wbf is None:
        wbf = pack_color_bf16(weights, S, F, P, skips)
    dev = small.device
    lib = _build.load()
    nblocks = lib.arah_color_bwd_blocks(n, meta)
    if nblocks <= 0:
        raise RuntimeError('color_bwd kernel: no launch configuration')
    partial = torch.zeros((nblocks, size), dtype=torch.float32, device=dev)
    grads = torch.zeros((size,), dtype=torch.float32, device=dev)
    dsmall = torch.empty((n, S), dtype=torch.float32, device=dev)
    dfeats = torch.empty((n, F), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.arah_color_bwd_ws(n, meta),), dtype=torch.float32,
                     device=dev)
    _build.check(lib.arah_color_bwd(
        small.data_ptr(), feats.data_ptr(),
        pose_t.data_ptr() if pose_t is not None else None, g_rgb.data_ptr(),
        n, params.data_ptr(), None if wbf is None else wbf.data_ptr(), meta,
        dsmall.data_ptr(), dfeats.data_ptr(),
        partial.data_ptr(), nblocks, size, grads.data_ptr(), ws.data_ptr(),
        _build.stream_ptr(small)), 'color_bwd')
    trace.COUNTS['color_bwd'] += 1
    dW, off = [], 0
    for w in weights:
        dW.append(grads[off:off + w.numel()].reshape(w.shape))
        off += w.numel()
    db = []
    for b in biases:
        db.append(grads[off:off + b.numel()].reshape(b.shape))
        off += b.numel()
    dpose = grads[off:off + P].reshape(1, P) if P else None
    nc = n - (n - 1) // CB_CHUNK * CB_CHUNK
    rows = ws.view(torch.bfloat16) if bf16 else ws     # bf16 rows under bf16
    deltas = [rows[nc * meta.wd_off[l]:nc * (meta.wd_off[l] + w.shape[0])]
              .reshape(nc, w.shape[0]).float()
              for l, w in enumerate(weights)]
    xs = [None] + [rows[nc * meta.wx_off[l]:
                        nc * (meta.wx_off[l] + w.shape[0])]
                   .reshape(nc, w.shape[0]).float()
                   for l, w in enumerate(weights[:-1], start=1)]
    return (dW, db, dsmall, dfeats, dpose), deltas, xs


class _ColorMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, skips, squeeze_out, bf16, n_layers, small, feats, pose,
                *wb):
        weights, biases = wb[:n_layers], wb[n_layers:]
        ctx.cfg = (skips, squeeze_out, bf16, n_layers)
        ctx.save_for_backward(small, feats, pose, *wb)
        # the bf16 weight blocks, built once for D and I
        ctx.wbf = None
        if bf16 and small.is_cuda:
            ctx.wbf = pack_color_bf16(weights, small.shape[1],
                                      feats.shape[1],
                                      0 if pose is None else pose.shape[-1],
                                      skips)
        return color_fwd(weights, biases, small, feats, pose, skips,
                         squeeze_out, bf16, ctx.wbf)

    @staticmethod
    def backward(ctx, g_rgb):
        skips, squeeze_out, bf16, L = ctx.cfg
        small, feats, pose, *wb = ctx.saved_tensors
        dW, db, dsmall, dfeats, dpose = color_bwd(
            wb[:L], wb[L:], small, feats, pose, g_rgb, skips, squeeze_out,
            bf16, ctx.wbf)
        if dpose is not None:
            dpose = dpose.reshape(pose.shape)
        return (None, None, None, None, dsmall, dfeats.to(feats.dtype),
                dpose, *dW, *db)


def color_mlp_fused(weights, biases, small, feats, pose, skips: tuple,
                    squeeze_out: bool = True, bf16: bool = False):
    """The D -> I op: rgb (N, out) of the colour MLP, differentiable in
    the weights, biases, small, feats and pose. weights: L dense (out,
    in) matrices (weight norm applied) with columns in the x0/skip layout
    above; small (N, S) f32; feats (N, F) f32 or bf16; pose (1, P) or
    None."""
    return _ColorMLP.apply(tuple(skips), bool(squeeze_out), bool(bf16),
                           len(weights), small.contiguous(),
                           feats.contiguous(), pose, *weights, *biases)
