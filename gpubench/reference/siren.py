"""SIREN SDF networks with hypernetwork-generated weights.
A frozen copy of the port's `nn/siren.py`."""
from __future__ import annotations

from typing import NamedTuple

import torch

from gpubench.reference.layers import mm_t


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
