"""SIREN SDF networks with hypernetwork-generated weights.
Port of `arah_tpu/nn/siren.py`."""
from __future__ import annotations

from typing import NamedTuple

import torch

from arah_tpu_torch.nn.layers import init_linear, mm_t


class GeneratedMLP(NamedTuple):
    """Weights of a generated SIREN MLP."""
    weights: tuple      # L tensors (out, in)
    biases: tuple       # L tensors (out,)
    freqs: tuple        # L-1 FiLM frequencies (hidden,), or ()
    phases: tuple       # L-1 FiLM phase shifts (hidden,), or ()


def siren_apply(gen: GeneratedMLP, x: torch.Tensor,
                return_features: bool = False, bf16: bool = False):
    """Generated SIREN at points x (..., in_dim): sdf (..., out_dim) and,
    if asked, the penultimate activation (the colour net's feature).

    bf16: operands rounded to bf16 with f32 accumulation, and the
    inter-layer activations (the returned features too) stored in bf16.
    """
    h = x
    use_film = len(gen.freqs) > 0
    for i in range(len(gen.weights) - 1):
        h = mm_t(h, gen.weights[i], bf16) + gen.biases[i]
        if use_film:
            h = gen.freqs[i] * h + gen.phases[i]
        h = torch.sin(30.0 * h)
        if bf16:
            h = h.bfloat16()
    out = mm_t(h, gen.weights[-1], bf16) + gen.biases[-1]
    if return_features:
        return out, h
    return out


def init_plain_siren(gen: torch.Generator, dims, device='cpu'):
    """A trainable (not generated) SIREN, the `single_bvp` decoder
    variant: linear layers with the SIREN init ('sine_first' for layer 0,
    'sine' after), drawn from `gen`."""
    return [init_linear(gen, dims[i], dims[i + 1],
                        'sine_first' if i == 0 else 'sine', device)
            for i in range(len(dims) - 1)]


def plain_siren_as_generated(layers) -> GeneratedMLP:
    """The layers of `init_plain_siren` as a GeneratedMLP without FiLM."""
    return GeneratedMLP(weights=tuple(l['w'] for l in layers),
                        biases=tuple(l['b'] for l in layers),
                        freqs=(), phases=())


def fold_film(gen: GeneratedMLP):
    """The layers of a plain SIREN (`init_plain_siren`'s form) that
    computes what the generated SIREN `gen` computes: each FiLM layer
    sin(30 (f (W h + b) + p)) folds into the linear layer W' = diag(f) W,
    b' = f b + p (equal up to rounding)."""
    L = len(gen.weights)
    film = len(gen.freqs) > 0
    layers = []
    for i in range(L):
        w, b = gen.weights[i], gen.biases[i]
        if film and i < L - 1:
            f, p = gen.freqs[i], gen.phases[i]
            w, b = f[:, None] * w, f * b + p
        layers.append({'w': w, 'b': b})
    return layers
