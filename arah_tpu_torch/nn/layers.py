"""Functional linear-layer primitives over nested parameter dicts.
Port of `arah_tpu/nn/layers.py`: the same tree keys and init laws,
drawn from an explicit `torch.Generator` (so not the same numbers).

Initialisers draw on the CPU from the generator and then move to the
requested device, so a seed gives the same parameters on every device.
"""
from __future__ import annotations

import math

import torch


def _uniform(gen, shape, bound):
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def _normal(gen, shape):
    return torch.empty(shape).normal_(generator=gen)


def init_linear(gen: torch.Generator, in_features: int, out_features: int,
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
        w = torch.zeros(shape)
    else:
        raise ValueError(f'unknown init {w_init}')
    b = _uniform(gen, (out_features,), 1.0 / math.sqrt(in_features))
    if w_init == 'zeros':
        b = torch.zeros((out_features,))
    return {'w': w.to(device), 'b': b.to(device)}


def mm_t(x: torch.Tensor, w: torch.Tensor, bf16: bool = False):
    """x @ w.T in f32, or with both operands rounded to bf16 and the
    product accumulated and returned in f32 (the bf16 contract of the
    JAX `mm_t`; PyTorch's own bf16 `@` would round the result too)."""
    if not bf16:
        return x.float() @ w.float().T
    return x.bfloat16().float() @ w.bfloat16().float().T


def linear(params, x):
    """x @ w.T + b for (..., in) inputs (f32)."""
    return mm_t(x, params['w']) + params['b']


def init_wn_linear(gen: torch.Generator, in_features: int,
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


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta=100 and the linear region above 20/beta. The
    exponent is clamped at the threshold, which leaves every value as it
    was and keeps the unused branch's gradient finite (0, not inf * 0)."""
    bx = 100.0 * x
    return torch.where(bx > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp(bx, max=20.0)))
                       / 100.0)
