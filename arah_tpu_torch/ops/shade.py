"""Fused generated-SIREN shading: kernel C and its plain version.

`siren_shade` launches the CUDA kernel (csrc/shade.cu, the port of
`arah_tpu/ops/pallas/shade_kernel.py:siren_shade_pallas`) for CUDA
tensors and computes `siren_shade_plain` for CPU tensors. Both return
the SDF, the penultimate features and d(sdf)/dx from an explicit forward
pass (keeping the 30 f cos(30 z) factors) and reverse chain, with the
kernel's bf16 rounding points under `bf16`: every dot operand, including
g * df before each reverse product, with f32 accumulation.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.nn.siren import GeneratedMLP
from arah_tpu_torch.ops import _build


def pack_shade(gen: GeneratedMLP, bf16: bool):
    """(parameter buffer, ShadeMeta) of a generated SIREN for kernels C
    and H; raises on a shape they do not take."""
    L = len(gen.weights)
    din = gen.weights[0].shape[1]
    H = gen.weights[0].shape[0]
    dout = gen.weights[-1].shape[0]
    film = len(gen.freqs) > 0
    if (L < 2 or L > 8 or din > 4 or H % 4 or H > 256 or dout > 16
            or any(w.shape[0] != H for w in gen.weights[:-1])):
        raise ValueError('shade kernels: unsupported SIREN shape '
                         f'{[tuple(w.shape) for w in gen.weights]}')
    # under bf16 the hidden layers' weights are stored rounded (every use
    # is a dot operand; H relies on it); the output layer's row also seeds
    # the normal chain unrounded, so it is stored as it is
    ws = [w.detach().bfloat16().float() if bf16 and i < L - 1
          else w.detach() for i, w in enumerate(gen.weights)]
    pack = _build.ParamPack()
    wt_off = [pack.put(w.T.contiguous()) for w in ws]
    w_off = [pack.put(w) for w in ws]
    b_off = [pack.put(b.detach()) for b in gen.biases]
    f_off = pack.put(torch.stack(gen.freqs).detach()) if film else 0
    p_off = pack.put(torch.stack(gen.phases).detach()) if film else 0
    pad = [0] * (8 - L)
    LL = _build.ctypes.c_longlong * 8
    meta = _build.ShadeMeta(L, din, H, dout, int(film), int(bf16),
                            LL(*(wt_off + pad)), LL(*(w_off + pad)),
                            LL(*(b_off + pad)), f_off, p_off)
    return pack.tensor(), meta


def pack_shade_bf16(gen: GeneratedMLP):
    """Kernel H's tensor-core operands under bf16: the weights of the
    hidden (H, H) layers 1..L-2 in bf16, each as it is (out, in) and
    transposed, (L-2, 2, H, H). The values are those `pack_shade(gen,
    bf16=True)` stores (rounded to bf16, in f32)."""
    H = gen.weights[0].shape[0]
    ws = [w.detach().bfloat16() for w in gen.weights[1:-1]]
    if not ws:
        return torch.empty((0, 2, H, H), dtype=torch.bfloat16,
                           device=gen.weights[0].device)
    return torch.stack([torch.stack([w, w.T]) for w in ws]).contiguous()


def siren_shade_plain(gen: GeneratedMLP, x: torch.Tensor,
                      bf16: bool = False, feat_f32: bool = False):
    """(N, 3) points -> (sdf (N, out), feats (N, hidden), grad (N, 3));
    feats are bf16 under `bf16` (the eval path's dtype contract) unless
    `feat_f32` (the training op's)."""
    r = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    use_film = len(gen.freqs) > 0
    L = len(gen.weights)
    h = x
    dfs = []
    for i in range(L - 1):
        z = r(h) @ r(gen.weights[i]).T + gen.biases[i]
        if use_film:
            f = gen.freqs[i]
            z = f * z + gen.phases[i]
            dfs.append(30.0 * f * torch.cos(30.0 * z))
        else:
            dfs.append(30.0 * torch.cos(30.0 * z))
        h = torch.sin(30.0 * z)
    out = r(h) @ r(gen.weights[-1]).T + gen.biases[-1]
    g = gen.weights[-1][0:1, :].expand(x.shape[0], -1)
    for i in range(L - 2, -1, -1):
        g = r(g * dfs[i]) @ r(gen.weights[i])
    return out, (h.bfloat16() if bf16 and not feat_f32 else h), g


def siren_shade(gen: GeneratedMLP, x: torch.Tensor, bf16: bool = False,
                resid_bf16: bool = False, feat_f32: bool = False):
    """Kernel C: (N, 3) points -> (sdf, feats, d(sdf)/dx) as
    `siren_shade_plain`."""
    if not x.is_cuda:
        return siren_shade_plain(gen, x, bf16, feat_f32)
    if resid_bf16:
        raise NotImplementedError('shade kernel resid_bf16 (a TPU A/B) is '
                                  'not ported')
    n, din = x.shape
    H = gen.weights[0].shape[0]
    dout = gen.weights[-1].shape[0]
    _build.require(x, 'x', torch.float32, (n, din))
    params, meta = pack_shade(gen, bf16)
    sdf = torch.empty((n, dout), dtype=torch.float32, device=x.device)
    feat = torch.empty((n, H), dtype=torch.bfloat16 if bf16 and not feat_f32
                       else torch.float32, device=x.device)
    grad = torch.empty((n, din), dtype=torch.float32, device=x.device)
    lib = _build.load()
    _build.check(lib.arah_shade(x.data_ptr(), n, params.data_ptr(), meta,
                                sdf.data_ptr(), feat.data_ptr(),
                                int(feat_f32), grad.data_ptr(),
                                _build.stream_ptr(x)),
                 'shade')
    _build.COUNTS['shade'] += 1
    return sdf, feat, grad
