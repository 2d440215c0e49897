"""Ray/AABB slab test. Port of `arah_tpu/core/rays.py:ray_aabb`."""
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
