"""Single-scalar deviation (beta) for the VolSDF density.
A frozen copy of the port's `nn/deviation.py`."""
from __future__ import annotations

import torch


def init_deviation(init_val: float = 1e-3, device='cpu'):
    return {'variance': torch.tensor(init_val, dtype=torch.float32,
                                     device=device)}


def deviation_value(params):
    return torch.abs(params['variance'])
