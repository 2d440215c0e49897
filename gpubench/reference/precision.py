"""The precision of the reference's products.

As the configuration states it (`bf16_shading`): the shading's and the
colour MLP's product operands rounded to bf16 with f32 sums, every other
product in f32 (TF32 off). `lower()` is the control: every product one
precision below that, fp8 (e4m3) operands where the configuration states
bf16 and bf16 where it states f32, the sums still f32.
"""
from __future__ import annotations

import contextlib

import torch

_LOWER = [False]


@contextlib.contextmanager
def lower():
    """Every product of the reference one precision lower, inside."""
    _LOWER[0] = True
    try:
        yield
    finally:
        _LOWER[0] = False


def _through(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).float()


def rounder(bf16: bool):
    """t -> t as a product operand: through bf16 where the configuration
    states bf16 products, else as it is; under `lower()` one precision
    lower."""
    if _LOWER[0]:
        dtype = torch.float8_e4m3fn if bf16 else torch.bfloat16
        return lambda t: _through(t, dtype)
    return (lambda t: _through(t, torch.bfloat16)) if bf16 \
        else (lambda t: t)
