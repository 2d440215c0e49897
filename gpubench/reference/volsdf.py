"""VolSDF density and masked alpha compositing over dense
(n_rays, n_samples) blocks. A frozen copy of the port's `render/volsdf.py`."""
from __future__ import annotations

from typing import NamedTuple

import torch


def volsdf_density(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Laplace-CDF density of metric SDF values, beta a positive scalar."""
    beta = torch.clamp(beta, 1e-6, 1e6)
    inv_beta = 1.0 / beta
    inner = 0.5 + 0.5 * torch.sign(-sdf) * (
        1.0 - torch.exp(-torch.abs(sdf) * inv_beta))
    return torch.relu(inv_beta * inner)


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor          # (n_rays, 3)
    weights_sum: torch.Tensor  # (n_rays,) clipped to [0, 1]
    weights: torch.Tensor      # (n_rays, n_samples), original sample order


def composite_masked(rgb_vals: torch.Tensor, density: torch.Tensor,
                     z_vals: torch.Tensor, mask: torch.Tensor, n_steps: int,
                     render_last_pt: bool = False) -> CompositeOutput:
    """Alpha-composite masked samples without left-packing: a valid
    sample's interval runs to its next valid successor (an exclusive
    suffix-min of the masked depths); invalid slots get alpha 0 and a
    transmittance factor of exactly 1."""
    n_rays = density.shape[0]
    inf = torch.full_like(z_vals, float('inf'))
    density = torch.where(mask, density, torch.zeros_like(density))
    z_masked = torch.where(mask, z_vals, inf)
    suffix_min = torch.flip(torch.cummin(torch.flip(z_masked, [1]), 1)[0],
                            [1])
    next_z = torch.cat([suffix_min[:, 1:], inf[:, :1]], dim=-1)
    has_next = torch.isfinite(next_z)
    last_dist = 1e10 if render_last_pt else 1.0 / n_steps
    dists = torch.where(has_next, next_z - z_vals,
                        torch.full_like(z_vals, last_dist))
    expo = density * torch.where(mask, dists, torch.zeros_like(dists))
    alpha = 1.0 - torch.exp(-expo)
    factor = torch.where(mask, 1.0 - alpha + 1e-7, torch.ones_like(alpha))
    trans = torch.cumprod(torch.cat(
        [torch.ones((n_rays, 1), dtype=alpha.dtype, device=alpha.device),
         factor], dim=-1), dim=-1)[:, :-1]
    weights = alpha * trans * mask
    weights_sum = torch.clamp(weights.sum(dim=-1), 0.0, 1.0)
    rgb = torch.sum(rgb_vals * weights[..., None], dim=1)
    return CompositeOutput(rgb, weights_sum, weights)
