"""Ray/AABB slab test and stratified depth jitter. Port of
`arah_tpu/core/rays.py:ray_aabb` and `stratified_z_vals`."""
from __future__ import annotations

import torch


def ray_aabb(bounds_min: torch.Tensor, bounds_max: torch.Tensor,
             ray_o: torch.Tensor, ray_d: torch.Tensor, eps: float = 1e-5):
    """(near, far, hit) for rays (..., 3) against the box; near/far are in
    units of |ray_d| (divided by the ray norm, as the reference does)."""
    norm_d = torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    viewdir = ray_d / norm_d
    viewdir = torch.where((viewdir < eps) & (viewdir > -1e-10),
                          torch.full_like(viewdir, eps), viewdir)
    viewdir = torch.where((viewdir > -eps) & (viewdir < 1e-10),
                          torch.full_like(viewdir, -eps), viewdir)
    tmin = (bounds_min - ray_o) / viewdir
    tmax = (bounds_max - ray_o) / viewdir
    t1 = torch.minimum(tmin, tmax)
    t2 = torch.maximum(tmin, tmax)
    near = torch.amax(t1, dim=-1)
    far = torch.amin(t2, dim=-1)
    hit = near < far
    return near / norm_d[..., 0], far / norm_d[..., 0], hit


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
