"""Root-finding searches for canonical correspondences and ray-surface
intersections. A frozen copy of the port's `solver/root_find.py`:

  * `forward_skinning`         canonical point -> posed point (skinning
                               network + LBS),
  * `search_canonical_corr`    Broyden on fwd(x_hat) = x_bar with the
                               analytic init Jacobian — the plain version
                               of the CUDA corr kernel (ops/corr.py),
  * `iso_init_inv_jacobian`    the joint (fwd_skin, sdf) init Jacobian by
                               forward-mode AD (`torch.func.jvp`),
  * `search_iso_surface_depth` joint 4-D root-find on (x_hat, z).

Everything is dense and fixed-shape with masks carried as data, and runs
without autograd (the reference runs its solvers under no_grad).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gpubench.reference.body import (normalize_canonical_points,
                                      sdf_to_metric, skinning)
from gpubench.reference.linalg import inv3x3, inv4x4
from gpubench.reference.broyden import broyden


class CanonicalFrame(NamedTuple):
    """Per-frame quantities of the skinning/root-finding pipeline."""
    bone_transforms: torch.Tensor  # (24, 4, 4) cano(Vitruvian) -> posed
    trans: torch.Tensor            # (3,) global translation
    coord_min: torch.Tensor        # ()
    coord_max: torch.Tensor        # ()
    center: torch.Tensor           # (3,)


def forward_skinning(skin_fn: Callable, frame: CanonicalFrame,
                     x_hat: torch.Tensor):
    """Canonical (metric) points (N, 3) -> (posed points (N, 3), T (N,4,4));
    skin_fn maps normalized canonical points (N, 3) to (N, 24) weights."""
    x_norm = normalize_canonical_points(
        x_hat, frame.coord_min, frame.coord_max, frame.center)
    return skinning(x_hat, skin_fn(x_norm), frame.bone_transforms)


def init_transforms_from_weights(w: torch.Tensor,
                                 bone_transforms: torch.Tensor):
    """(N, 24) weights x (24, 4, 4) -> (N, 4, 4)."""
    return torch.einsum('nj,jab->nab', w, bone_transforms)


class CorrResult(NamedTuple):
    x_hat: torch.Tensor     # (N, 3) canonical correspondences (metric)
    T_fwd: torch.Tensor     # (N, 4, 4) forward transforms
    valid: torch.Tensor     # (N,) bool converged
    diff: torch.Tensor      # (N,) residual norms
    active: torch.Tensor    # (N,) bool still iterating at max_steps
    iters: torch.Tensor     # (N,) int32 Broyden iterations each point ran


@torch.no_grad()
def search_canonical_corr(skin_fn: Callable, frame: CanonicalFrame,
                          x_bar: torch.Tensor, x_hat_0: torch.Tensor,
                          T_fwd_0: torch.Tensor, max_steps: int = 50,
                          cvg_thresh: float = 1e-5,
                          active_init: torch.Tensor | None = None
                          ) -> CorrResult:
    """x_hat with fwd_skin(x_hat) == x_bar (metric space, x_bar without
    the global translation)."""
    def g(x):
        x_bar_opt, T = forward_skinning(skin_fn, frame, x)
        return x_bar_opt - x_bar, T

    x0_norm = normalize_canonical_points(
        x_hat_0, frame.coord_min, frame.coord_max, frame.center)
    J0 = init_transforms_from_weights(skin_fn(x0_norm),
                                      frame.bone_transforms)[:, :3, :3]
    res = broyden(g, x_hat_0, T_fwd_0, inv3x3(J0), max_steps=max_steps,
                  cvg_thresh=cvg_thresh, active_init=active_init)
    return CorrResult(res.x, res.aux, res.valid, res.diff, res.active,
                      res.iters)


class IsoSurfaceResult(NamedTuple):
    x_hat: torch.Tensor      # (N, 3)
    z_depth: torch.Tensor    # (N,)
    T_fwd: torch.Tensor      # (N, 4, 4)
    converged: torch.Tensor  # (N,) bool
    active: torch.Tensor     # (N,) bool still iterating at max_steps


@torch.no_grad()
def iso_init_inv_jacobian(sdf_fn: Callable, skin_fn: Callable,
                          frame: CanonicalFrame, cam_rays: torch.Tensor,
                          x_hat_0: torch.Tensor) -> torch.Tensor:
    """Inverse of the joint init Jacobian [[grad_sdf, 0], [J_lbs, -ray]]
    (N, 4, 4), from three forward-mode tangent passes of the joint
    (fwd_skin, sdf) map."""
    def joint(x_hat):
        x_norm = normalize_canonical_points(
            x_hat, frame.coord_min, frame.coord_max, frame.center)
        x_bar, _ = skinning(x_hat, skin_fn(x_norm), frame.bone_transforms)
        s = sdf_to_metric(sdf_fn(x_norm), frame.coord_min, frame.coord_max)
        return x_bar, s

    jl_cols, gs_cols = [], []
    for k in range(3):
        t = torch.zeros_like(x_hat_0)
        t[:, k] = 1.0
        _, (xb_t, s_t) = torch.func.jvp(joint, (x_hat_0,), (t,))
        jl_cols.append(xb_t)
        gs_cols.append(s_t)
    J_lbs = torch.stack(jl_cols, dim=-1)                         # (N, 3, 3)
    grad_sdf = torch.stack(gs_cols, dim=-1)                      # (N, 3)
    n = x_hat_0.shape[0]
    top = torch.cat([grad_sdf[:, None, :],
                     torch.zeros((n, 1, 1), device=x_hat_0.device)], dim=-1)
    bottom = torch.cat([J_lbs, -cam_rays[..., None]], dim=-1)
    return inv4x4(torch.cat([top, bottom], dim=-2))


@torch.no_grad()
def search_iso_surface_depth(sdf_fn: Callable, skin_fn: Callable,
                             frame: CanonicalFrame, cam_pos: torch.Tensor,
                             cam_rays: torch.Tensor,
                             valid_mask: torch.Tensor,
                             x_hat_0: torch.Tensor, z_0: torch.Tensor,
                             T_fwd_0: torch.Tensor, max_steps: int = 50,
                             cvg_thresh: float = 1e-5) -> IsoSurfaceResult:
    """Joint 4-D root-find of the SDF iso-surface point along each ray.
    sdf_fn: normalized canonical points (N, 3) -> (N,) normalized SDF."""
    def g(u):
        x_hat = u[:, :3]
        x_bar_tgt = cam_rays * u[:, 3:4] + cam_pos - frame.trans
        x_bar_opt, T = forward_skinning(skin_fn, frame, x_hat)
        x_norm = normalize_canonical_points(
            x_hat, frame.coord_min, frame.coord_max, frame.center)
        err_sdf = sdf_to_metric(sdf_fn(x_norm), frame.coord_min,
                                frame.coord_max)
        return torch.cat([err_sdf[:, None], x_bar_opt - x_bar_tgt],
                         dim=-1), T

    J_inv_0 = iso_init_inv_jacobian(sdf_fn, skin_fn, frame, cam_rays,
                                    x_hat_0)
    u0 = torch.cat([x_hat_0, z_0[:, None]], dim=-1)
    res = broyden(g, u0, T_fwd_0, J_inv_0, max_steps=max_steps,
                  cvg_thresh=cvg_thresh, active_init=valid_mask)
    return IsoSurfaceResult(res.x[:, :3], res.x[:, 3], res.aux, res.valid,
                            res.active)
