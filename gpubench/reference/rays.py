"""Stratified depth jitter: a frozen copy of the port's
`core/rays.py:stratified_z_vals`."""
from __future__ import annotations

import torch


def stratified_z_vals(z_vals: torch.Tensor, t_rand: torch.Tensor,
                      fix_idx: int | None = None) -> torch.Tensor:
    """Stratified perturbation of sorted per-ray depths: each sample moves
    to lower + (upper - lower) * t within its mid-point interval, with the
    uniform draws `t_rand` (same shape as z_vals) given by the caller
    (the port draws nothing itself). `fix_idx` pins one sample at t = 0.5
    (the surface point)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if fix_idx is not None:
        t_rand = t_rand.clone()
        t_rand[..., fix_idx] = 0.5
    return lower + (upper - lower) * t_rand
