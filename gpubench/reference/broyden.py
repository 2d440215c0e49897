"""Batched "good Broyden" root finder over dense point blocks, with
convergence masks carried as data. A frozen copy of the port's
`solver/broyden.py`:
rank-1 inverse-Jacobian updates with +/-eps denominators, best-so-far
(x, aux, |g|) tracking, per-point convergence (|g| < cvg_thresh) and
divergence (|g| >= dvg_thresh) freezing, and an early exit once no point
is active (one host sync per iteration)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class BroydenResult(NamedTuple):
    x: torch.Tensor        # (N, D) best-so-far roots
    aux: torch.Tensor      # aux output of g at the best x
    diff: torch.Tensor     # (N,) best |g|
    valid: torch.Tensor    # (N,) bool, |g| < cvg_thresh
    active: torch.Tensor   # (N,) bool, still iterating at max_steps
    steps: int             # iterations executed
    iters: torch.Tensor    # (N,) int32 iterations each point ran


def _bcast(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return m.reshape(m.shape + (1,) * (like.ndim - 1))


@torch.no_grad()
def broyden(g: Callable, x_init: torch.Tensor, aux_init: torch.Tensor,
            J_inv_init: torch.Tensor, max_steps: int = 50,
            cvg_thresh: float = 1e-5, dvg_thresh: float = 1.0,
            eps: float = 1e-6,
            active_init: torch.Tensor | None = None) -> BroydenResult:
    """Roots of g(x) = 0 for a batch of independent points.

    g: (N, D) -> ((N, D) residual, (N, ...) aux), evaluated densely;
    x_init (N, D); aux_init (N, ...); J_inv_init (N, D, D);
    active_init (N,) bool: False points never iterate, keep their init
    values and report valid=False.
    """
    N = x_init.shape[0]
    x = x_init
    J_inv = J_inv_init
    gx, _ = g(x)      # the aux of this evaluation is discarded (reference)
    update = -torch.einsum('nij,nj->ni', J_inv, gx)
    gx_norm_opt = torch.linalg.norm(gx, dim=-1)
    mask0 = torch.ones((N,), dtype=torch.bool, device=x.device) \
        if active_init is None else active_init.bool()
    active = mask0
    x_opt, aux_opt = x, aux_init
    iters = torch.zeros((N,), dtype=torch.int32, device=x.device)

    i = 0
    while i < max_steps and bool(active.any()):
        mD = active[:, None]
        delta_x = torch.where(mD, update, torch.zeros_like(update))
        x = x + delta_x
        gx_new, aux_new = g(x)
        gx_new = torch.where(mD, gx_new, gx)
        delta_gx = gx_new - gx

        gx_norm = torch.linalg.norm(gx_new, dim=-1)
        ids_opt = (gx_norm < gx_norm_opt) & active
        x_opt = torch.where(ids_opt[:, None], x, x_opt)
        aux_opt = torch.where(_bcast(ids_opt, aux_opt), aux_new, aux_opt)
        gx_norm_opt = torch.where(ids_opt, gx_norm, gx_norm_opt)

        new_active = (gx_norm_opt > cvg_thresh) & (gx_norm < dvg_thresh) \
            & active

        vT = torch.einsum('ni,nij->nj', delta_x, J_inv)
        a = delta_x - torch.einsum('nij,nj->ni', J_inv, delta_gx)
        b = torch.einsum('nj,nj->n', vT, delta_gx)[:, None]
        b = torch.where(b >= 0, b + eps, b - eps)
        u = a / b
        J_inv = J_inv + torch.where(mD[..., None], u[:, :, None]
                                    * vT[:, None, :], torch.zeros_like(J_inv))
        update = -torch.einsum('nij,nj->ni', J_inv, gx_new)
        gx = gx_new
        iters += active.int()
        active = new_active
        i += 1

    valid = (gx_norm_opt < cvg_thresh) & mask0
    x_opt = torch.where(mask0[:, None], x_opt, x_init)
    aux_opt = torch.where(_bcast(mask0, aux_opt), aux_opt, aux_init)
    return BroydenResult(x_opt, aux_opt, gx_norm_opt, valid, active, i,
                         iters)
