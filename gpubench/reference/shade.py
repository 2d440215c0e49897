"""The shading of the generated SIREN: the SDF, the penultimate features
and d(sdf)/dx from an explicit forward pass and reverse chain, and in
training its explicit backward (an autograd Function), with every
product's operands rounded as `precision.rounder` says and f32 sums. A
frozen copy of the plain versions of the port's shading op
(`ops/shade.py`, `ops/shade_grad.py`): autograd of the forward would
round the backward's products elsewhere than `bf16_shading` states.
"""
from __future__ import annotations

import torch

from gpubench.reference.precision import rounder
from gpubench.reference.siren import GeneratedMLP


def shade(gen: GeneratedMLP, x: torch.Tensor, bf16: bool = False,
          feat_f32: bool = False):
    """(N, 3) points -> (sdf (N, out), feats (N, hidden), grad (N, 3));
    feats are bf16 under `bf16` (the eval path's) unless `feat_f32` (the
    training op's)."""
    r = rounder(bf16)
    film = len(gen.freqs) > 0
    L = len(gen.weights)
    h = x
    dfs = []
    for i in range(L - 1):
        z = r(h) @ r(gen.weights[i]).T + gen.biases[i]
        if film:
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


def shade_bwd(gen: GeneratedMLP, x, g_out, g_feat, g_n, bf16: bool = False):
    """The backward of `shade` given the cotangents of its three outputs:
    (dx (N, 3), GeneratedMLP of the leaves' gradients)."""
    r = rounder(bf16)
    W, B = gen.weights, gen.biases
    L = len(W)
    film = len(gen.freqs) > 0
    h, C, z, c = [x], [], [], []
    hcur = x
    for i in range(L - 1):
        zi = r(hcur) @ r(W[i]).T + B[i]
        u = gen.freqs[i] * zi + gen.phases[i] if film else zi
        z.append(zi)
        Ci = torch.cos(30.0 * u)
        C.append(Ci)
        c.append(30.0 * gen.freqs[i] * Ci if film else 30.0 * Ci)
        hcur = torch.sin(30.0 * u)
        h.append(hcur)
    # the reverse normal chain, keeping g_{i+1} and a_i
    g_list, a_list = [None] * (L - 1), [None] * (L - 1)
    gcur = W[L - 1][0:1, :].expand(x.shape[0], -1)
    for i in range(L - 2, -1, -1):
        g_list[i] = gcur
        ai = gcur * c[i]
        a_list[i] = ai
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
            ubar_c[i] = -900.0 * gen.freqs[i] * h[i + 1] * cbar
        else:
            ubar_c[i] = -900.0 * h[i + 1] * cbar
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


class _ShadeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bf16, n_layers, film, x, *leaves):
        gen = _unflatten(leaves, n_layers, film)
        ctx.bf16, ctx.n_layers, ctx.film = bf16, n_layers, film
        ctx.save_for_backward(x, *leaves)
        return shade(gen, x.detach(), bf16=bf16, feat_f32=True)

    @staticmethod
    def backward(ctx, g_out, g_feat, g_n):
        x, *leaves = ctx.saved_tensors
        gen = _unflatten(leaves, ctx.n_layers, ctx.film)
        n = x.shape[0]

        def zeros(w):
            return torch.zeros((n, w), dtype=x.dtype, device=x.device)
        g_out = zeros(gen.weights[-1].shape[0]) if g_out is None else g_out
        g_feat = zeros(gen.weights[-1].shape[1]) if g_feat is None \
            else g_feat
        g_n = zeros(x.shape[1]) if g_n is None else g_n
        dx, d = shade_bwd(gen, x, g_out.float(), g_feat.float(),
                          g_n.float(), ctx.bf16)
        return (None, None, None, dx, *d.weights, *d.biases, *d.freqs,
                *d.phases)


def _unflatten(leaves, n_layers: int, film: bool) -> GeneratedMLP:
    L = n_layers
    k = L - 1 if film else 0
    return GeneratedMLP(tuple(leaves[:L]), tuple(leaves[L:2 * L]),
                        tuple(leaves[2 * L:2 * L + k]),
                        tuple(leaves[2 * L + k:2 * L + 2 * k]))


def shade_grad(gen: GeneratedMLP, x: torch.Tensor, bf16: bool = False):
    """(sdf, features, normal) of the generated SIREN at (N, 3) points,
    f32, differentiable in every leaf of `gen` and in x."""
    film = len(gen.freqs) > 0
    return _ShadeGrad.apply(bool(bf16), len(gen.weights), film, x,
                            *gen.weights, *gen.biases, *gen.freqs,
                            *gen.phases)
