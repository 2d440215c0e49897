"""Differentiable fused shading of the training step: the C -> H op.

`siren_shade_grad(gen, x, bf16, resid_bf16)` returns (sdf (N, out),
features (N, hidden), normal d(sdf[:, 0])/dx (N, 3)), all f32, as a
`torch.autograd.Function`. Its forward is the shading kernel C
(csrc/shade.cu, features kept in f32 as the JAX training op returns them)
and its backward the kernel H (csrc/shade_bwd.cu, the port of
`arah_tpu/ops/pallas/shade_grad_kernel.py:_shade_bwd_pallas`), which
gives the gradients of every `GeneratedMLP` leaf and of the points. For
CPU tensors both sides compute their plain versions: `siren_shade_plain`
and `shade_bwd_plain`, the explicit forward and backward of
`shade_grad_kernel.py:_make_op_xla` with the kernels' bf16 rounding
points (every product's operands rounded under `bf16`, f32
accumulation). Autograd of the forward is not a plain version: under
bf16 it rounds elsewhere, and it would hold the (N, 3, hidden) tangent
chain.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.nn.siren import GeneratedMLP
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.shade import (_rounder, pack_shade,
                                      pack_shade_bf16, siren_shade)
from arah_tpu_torch.utils import trace


def shade_bwd_plain(gen: GeneratedMLP, x, g_out, g_feat, g_n,
                    bf16: bool = False, resid_bf16: bool = False):
    """Plain version of kernel H. Returns (dx (N, 3), GeneratedMLP of the
    leaves' gradients). `resid_bf16` rounds every resident where the TPU
    kernel's `st` stores it (`shade_grad_kernel.py:90-170`): h_{i+1}, C,
    z, c, g, a and ubar_c (so the features, h_{L-1}, that feed dW_{L-1}
    too); the running chain, t and every cotangent product stay f32."""
    r, st = _rounder(bf16), _rounder(resid_bf16)
    W, B = gen.weights, gen.biases
    L = len(W)
    film = len(gen.freqs) > 0
    h, C, z, c = [x], [], [], []
    hcur = x
    for i in range(L - 1):
        zi = r(hcur) @ r(W[i]).T + B[i]
        u = gen.freqs[i] * zi + gen.phases[i] if film else zi
        z.append(st(zi))
        Ci = torch.cos(30.0 * u)
        C.append(st(Ci))
        c.append(st(30.0 * gen.freqs[i] * Ci if film else 30.0 * Ci))
        hcur = torch.sin(30.0 * u)
        h.append(st(hcur))
    # the reverse normal chain, keeping g_{i+1} and a_i
    g_list, a_list = [None] * (L - 1), [None] * (L - 1)
    gcur = W[L - 1][0:1, :].expand(x.shape[0], -1)
    for i in range(L - 2, -1, -1):
        g_list[i] = st(gcur)
        ai = gcur * c[i]
        a_list[i] = st(ai)
        gcur = r(ai) @ r(W[i])
    dW, db = [None] * L, [None] * L
    dfr, dph = [None] * (L - 1), [None] * (L - 1)
    # adjoint of the reverse chain: a forward sweep seeded with g_n
    t = g_n
    ubar_c = [None] * (L - 1)
    for i in range(L - 1):
        abar = r(t) @ r(W[i]).T
        dW[i] = r(a_list[i]).T @ r(t)
        cbar = g_list[i] * abar
        if film:
            dfr[i] = torch.sum(30.0 * C[i] * cbar, dim=0)
            ubar_c[i] = st(-900.0 * gen.freqs[i] * h[i + 1] * cbar)
        else:
            ubar_c[i] = st(-900.0 * h[i + 1] * cbar)
        t = c[i] * abar
    dWl = r(g_out).T @ r(h[L - 1])
    dWl = torch.cat([dWl[:1] + t.sum(dim=0, keepdim=True), dWl[1:]])
    dW[L - 1] = dWl
    db[L - 1] = g_out.sum(dim=0)
    hbar = r(g_out) @ r(W[L - 1]) + g_feat
    # the primal backward, with the second-order term ubar_c
    for i in range(L - 2, -1, -1):
        ubar = 30.0 * C[i] * hbar + ubar_c[i]
        if film:
            dfr[i] = dfr[i] + torch.sum(z[i] * ubar, dim=0)
            dph[i] = torch.sum(ubar, dim=0)
            zbar = gen.freqs[i] * ubar
        else:
            zbar = ubar
        dW[i] = dW[i] + r(zbar).T @ r(h[i])
        db[i] = zbar.sum(dim=0)
        hbar = r(zbar) @ r(W[i])
    return hbar, GeneratedMLP(tuple(dW), tuple(db),
                              tuple(dfr) if film else (),
                              tuple(dph) if film else ())


def shade_bwd(gen: GeneratedMLP, x, g_out, g_feat, g_n, bf16: bool = False,
              resid_bf16: bool = False):
    """Kernel H: the backward of the shading op (see `shade_bwd_plain`)."""
    if not x.is_cuda:
        return shade_bwd_plain(gen, x, g_out, g_feat, g_n, bf16, resid_bf16)
    n, din = x.shape
    L = len(gen.weights)
    H = gen.weights[0].shape[0]
    dout = gen.weights[-1].shape[0]
    film = len(gen.freqs) > 0
    params, meta = pack_shade(gen, bf16, resid_bf16)
    if bf16 and H % 32:
        raise ValueError('shade_bwd kernel: its bf16 tensor-core products '
                         f'take a hidden width divisible by 32, not {H}')
    wbf = pack_shade_bf16(gen) if bf16 else None
    x = x.detach().contiguous()
    g_out, g_feat, g_n = (g.detach().float().contiguous()
                          for g in (g_out, g_feat, g_n))
    for a, name, shape in ((x, 'x', (n, din)), (g_out, 'g_out', (n, dout)),
                           (g_feat, 'g_feat', (n, H)), (g_n, 'g_n', (n, din))):
        _build.require(a, name, torch.float32, shape)
    # the gradient buffer's layout: dW (out, in) and db per layer, then
    # dfreqs and dphases (L-1, H)
    offs, size = [], 0
    for shp in ([tuple(w.shape) for w in gen.weights]
                + [tuple(b.shape) for b in gen.biases]
                + ([(L - 1, H)] * 2 if film else [])):
        offs.append(size)
        size += int(torch.Size(shp).numel())
    LL = _build.ctypes.c_longlong * 8
    pad = [0] * (8 - L)
    gmeta = _build.ShadeMeta(
        L, din, H, dout, int(film), int(bf16), int(resid_bf16),
        LL(*([0] * 8)),
        LL(*(offs[:L] + pad)), LL(*(offs[L:2 * L] + pad)),
        offs[2 * L] if film else 0, offs[2 * L + 1] if film else 0)
    lib = _build.load()
    nblocks = lib.arah_shade_bwd_blocks(n, meta)
    if nblocks <= 0:
        raise RuntimeError('shade_bwd kernel: no launch configuration')
    partial = torch.zeros((nblocks, size), dtype=torch.float32,
                          device=x.device)
    grads = torch.zeros((size,), dtype=torch.float32, device=x.device)
    dx = torch.empty((n, din), dtype=torch.float32, device=x.device)
    ws = torch.empty((lib.arah_shade_bwd_ws(n, nblocks, meta),),
                     dtype=torch.float32, device=x.device)
    _build.check(lib.arah_shade_bwd(
        x.data_ptr(), n, params.data_ptr(),
        None if wbf is None else wbf.data_ptr(), meta, g_out.data_ptr(),
        g_feat.data_ptr(), g_n.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        nblocks, gmeta, size, grads.data_ptr(), ws.data_ptr(),
        _build.stream_ptr(x)), 'shade_bwd')
    trace.COUNTS['shade_bwd_resid' if resid_bf16 else 'shade_bwd'] += 1

    def take(i, shp):
        end = offs[i + 1] if i + 1 < len(offs) else size
        return grads[offs[i]:end].reshape(shp)
    dW = tuple(take(i, w.shape) for i, w in enumerate(gen.weights))
    db = tuple(take(L + i, b.shape) for i, b in enumerate(gen.biases))
    dfr = tuple(take(2 * L, (L - 1, H))) if film else ()
    dph = tuple(take(2 * L + 1, (L - 1, H))) if film else ()
    return dx, GeneratedMLP(dW, db, dfr, dph)


class _ShadeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bf16, resid_bf16, n_layers, film, x, *leaves):
        gen = _unflatten(leaves, n_layers, film)
        ctx.bf16, ctx.resid_bf16 = bf16, resid_bf16
        ctx.n_layers, ctx.film = n_layers, film
        ctx.save_for_backward(x, *leaves)
        return siren_shade(gen, x.detach().contiguous(), bf16=bf16,
                           resid_bf16=resid_bf16, feat_f32=True)

    @staticmethod
    def backward(ctx, g_out, g_feat, g_n):
        x, *leaves = ctx.saved_tensors
        gen = _unflatten(leaves, ctx.n_layers, ctx.film)
        n = x.shape[0]
        zeros = lambda w: torch.zeros((n, w), dtype=x.dtype, device=x.device)
        g_out = zeros(gen.weights[-1].shape[0]) if g_out is None else g_out
        g_feat = zeros(gen.weights[-1].shape[1]) if g_feat is None else g_feat
        g_n = zeros(x.shape[1]) if g_n is None else g_n
        dx, d = shade_bwd(gen, x, g_out, g_feat, g_n, ctx.bf16,
                          ctx.resid_bf16)
        return (None, None, None, None, dx, *d.weights, *d.biases,
                *d.freqs, *d.phases)


def _unflatten(leaves, n_layers: int, film: bool) -> GeneratedMLP:
    L = n_layers
    k = L - 1 if film else 0
    return GeneratedMLP(tuple(leaves[:L]), tuple(leaves[L:2 * L]),
                        tuple(leaves[2 * L:2 * L + k]),
                        tuple(leaves[2 * L + k:2 * L + 2 * k]))


def siren_shade_grad(gen: GeneratedMLP, x: torch.Tensor, bf16: bool = False,
                     resid_bf16: bool = False):
    """The C -> H op: (sdf, features, normal) of the generated SIREN at
    (N, 3) points, f32, differentiable in every leaf of `gen` and in x.
    `resid_bf16` keeps C's and H's residents in bf16 as the TPU kernels
    do, on the card and on the CPU alike (the plain versions round where
    the kernels do). JAX's own CPU twin of the op ignores the flag; its
    Pallas kernels in interpret mode honour it."""
    film = len(gen.freqs) > 0
    return _ShadeGrad.apply(bool(bf16), bool(resid_bf16), len(gen.weights),
                            film, x, *gen.weights, *gen.biases, *gen.freqs,
                            *gen.phases)

