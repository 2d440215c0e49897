"""Functional linear-layer primitives over nested parameter dicts.
A frozen copy of the port's `nn/layers.py`: the same tree keys and init
laws.

The initialisers take their random numbers from a `Draws`, which draws
them on its device from a seeded `torch.Generator` in a few large calls.
"""
from __future__ import annotations

import math

import torch

from gpubench.reference.precision import rounder


class Draws:
    """Uniform and normal numbers for the initialisers, on `device`: each
    kind is drawn from one seeded generator in blocks of `block` values
    and handed out in order, so one seed gives one parameter tree."""

    def __init__(self, seed: int, device, block: int = 1 << 24):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.block = block
        self._buf = {'uniform': None, 'normal': None}
        self._pos = {'uniform': 0, 'normal': 0}

    def _take(self, kind: str, shape):
        n = math.prod(shape)
        buf, pos = self._buf[kind], self._pos[kind]
        if buf is None or pos + n > buf.numel():
            buf = torch.empty(max(n, self.block), device=self.device)
            if kind == 'uniform':
                buf.uniform_(generator=self.gen)
            else:
                buf.normal_(generator=self.gen)
            self._buf[kind], pos = buf, 0
        self._pos[kind] = pos + n
        return buf[pos:pos + n].reshape(shape)

    def uniform(self, shape, bound: float):
        return (self._take('uniform', shape) * 2.0 - 1.0) * bound

    def normal(self, shape):
        return self._take('normal', shape).clone()

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device)


def _uniform(gen: Draws, shape, bound):
    return gen.uniform(shape, bound)


def _normal(gen: Draws, shape):
    return gen.normal(shape)


def init_linear(gen: Draws, in_features: int, out_features: int,
                w_init: str = 'torch_default', device='cpu'):
    """Returns {'w': (out, in), 'b': (out,)}; w_init as in the JAX
    package: torch_default | kaiming_relu | kaiming_leaky02 | sine |
    sine_first | zeros."""
    shape = (out_features, in_features)
    if w_init == 'torch_default':
        w = _uniform(gen, shape, 1.0 / math.sqrt(in_features))
    elif w_init == 'kaiming_relu':
        w = _normal(gen, shape) * math.sqrt(2.0 / in_features)
    elif w_init == 'kaiming_leaky02':
        gain = math.sqrt(2.0 / (1 + 0.2 ** 2))
        w = _normal(gen, shape) * gain / math.sqrt(in_features)
    elif w_init == 'sine':
        w = _uniform(gen, shape, math.sqrt(6.0 / in_features) / 30.0)
    elif w_init == 'sine_first':
        w = _uniform(gen, shape, 1.0 / in_features)
    elif w_init == 'zeros':
        w = gen.zeros(shape)
    else:
        raise ValueError(f'unknown init {w_init}')
    b = _uniform(gen, (out_features,), 1.0 / math.sqrt(in_features))
    if w_init == 'zeros':
        b = gen.zeros((out_features,))
    return {'w': w.to(device), 'b': b.to(device)}


def mm_t(x: torch.Tensor, w: torch.Tensor, bf16: bool = False):
    """x @ w.T with f32 sums, the operands rounded as `precision.rounder`
    says: to bf16 under `bf16`, else as they are."""
    r = rounder(bf16)
    return r(x.float()) @ r(w.float()).T


def linear(params, x):
    """x @ w.T + b for (..., in) inputs (f32)."""
    return mm_t(x, params['w']) + params['b']


def init_wn_linear(gen: Draws, in_features: int,
                   out_features: int, w_init: str = 'torch_default',
                   device='cpu'):
    """Weight-normalized linear: {'v': (out, in), 'g': (out, 1), 'b'}."""
    p = init_linear(gen, in_features, out_features, w_init, device)
    g = torch.linalg.norm(p['w'], dim=1, keepdim=True)
    return {'v': p['w'], 'g': g, 'b': p['b']}


def wn_weight(params) -> torch.Tensor:
    """Dense W = g * v / ||v||_row of a weight-normalized layer."""
    v = params['v']
    return params['g'] * v / torch.linalg.norm(v, dim=1, keepdim=True)


def wn_linear(params, x, bf16: bool = False):
    return mm_t(x, wn_weight(params), bf16) + params['b']


def geometric_init_mlp(gen: Draws, dims, *, skip_in=(),
                       cond_in=(), cond_dim: int = 0, bias: float = 1.0,
                       inside_outside: bool = False, multires: int = 0,
                       weight_norm: bool = True, device='cpu'):
    """IDR/SAL geometric initialisation of a softplus MLP (`dims` holds
    the input and output widths), the law of the JAX
    `geometric_init_mlp`: the last layer's weights ~ sqrt(pi)/sqrt(in)
    (negated with `inside_outside`) plus N(0, 1e-4) and its bias -bias
    (+bias with `inside_outside`); hidden weights N(0, 2/out), zero
    biases; with positional encoding, layer 0 reads only the raw xyz
    columns and a skip layer's encoding columns start at zero. Returns a
    list of layer dicts, weight-normed if `weight_norm`."""
    n_layers = len(dims) - 1
    layers = []
    for l in range(n_layers):
        in_dim = dims[l] + (cond_dim if l in cond_in else 0)
        out_dim = dims[l + 1] - (dims[0] if l + 1 in skip_in else 0)
        std = math.sqrt(2) / math.sqrt(out_dim)
        if l == n_layers - 1:
            mean = math.sqrt(math.pi) / math.sqrt(in_dim)
            if inside_outside:
                mean, b_val = -mean, bias
            else:
                b_val = -bias
            w = _normal(gen, (out_dim, in_dim)) * 1e-4 + mean
            b = torch.full((out_dim,), float(b_val), device=gen.device)
        elif multires > 0 and l == 0:
            w = gen.zeros((out_dim, in_dim))
            w[:, :3] = _normal(gen, (out_dim, 3)) * std
            b = gen.zeros((out_dim,))
        else:
            w = _normal(gen, (out_dim, in_dim)) * std
            if multires > 0 and l in skip_in:
                w[:, -(dims[0] - 3):] = 0.0
            b = gen.zeros((out_dim,))
        if weight_norm:
            layers.append({'v': w.to(device),
                           'g': torch.linalg.norm(w, dim=1,
                                                  keepdim=True).to(device),
                           'b': b.to(device)})
        else:
            layers.append({'w': w.to(device), 'b': b.to(device)})
    return layers


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta=100 and the linear region above 20/beta. The
    exponent is clamped at the threshold, which leaves every value as it
    was and keeps the unused branch's gradient finite (0, not inf * 0)."""
    bx = 100.0 * x
    return torch.where(bx > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp(bx, max=20.0)))
                       / 100.0)
