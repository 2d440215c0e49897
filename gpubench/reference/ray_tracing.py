"""Dense ray tracer of the plain reference: KNN-skinning sphere tracing,
the joint (canonical point, depth) root-finding refinement, near/far
surface sampling and the canonical-correspondence search of every ray
sample, in plain torch. A frozen copy of the plain loops of the port's
`render/ray_tracing.py` with its kernels and their dispatch left out.

The straggler-resolve splits are part of the configuration
(`*_phase1_steps`, `*_resolve_cap` in `configs/default.yaml`), so the
reference runs them too: phase 1 caps every ray or point, and the first
`cap` still-active ones are solved again and written back to their rows.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gpubench.reference.body import (apply_transform,
                                     normalize_canonical_points,
                                     sdf_to_metric,
                                     unnormalize_canonical_points)
from gpubench.reference.linalg import inv_affine
from gpubench.reference.rays import stratified_z_vals
from gpubench.reference.root_find import (CanonicalFrame,
                                          search_canonical_corr,
                                          search_iso_surface_depth)


class RayTracerConfig(NamedTuple):
    root_finding_threshold: float = 1e-5
    sphere_tracing_iters: int = 50
    n_steps: int = 64
    near_surface_vol_samples: int = 16
    far_surface_vol_samples: int = 16
    surface_vol_range: float = 0.05
    clamp_dist: float = 0.1
    corr_max_steps: int = 50
    iso_max_steps: int = 50
    corr_phase1_steps: int = 0
    corr_resolve_cap: int = 4096
    march_phase1_steps: int = 0
    march_resolve_cap: int = 512
    iso_phase1_steps: int = 0
    iso_resolve_cap: int = 512


class SmplRef(NamedTuple):
    """Posed SMPL reference data for KNN-based initialization."""
    verts_posed: torch.Tensor        # (V, 3) posed verts in world
    skinning_weights: torch.Tensor   # (V, 24)


class SphereTraceResult(NamedTuple):
    points_norm: torch.Tensor   # (N, 3) canonical surface points
    transforms: torch.Tensor    # (N, 4, 4) forward transforms at surface
    unconverged: torch.Tensor   # (N,) bool
    start_dis: torch.Tensor     # (N,) surface depth (or near bound)
    end_dis: torch.Tensor       # (N,) far bound


def nn_idx(points: torch.Tensor, verts: torch.Tensor,
           chunk: int = 16384) -> torch.Tensor:
    """(N, 3) points, (V, 3) verts -> (N,) nearest-vertex indices, in
    point chunks so that the (N, V) distance matrix stays small:
    argmin of |v|^2 - (x 2vx + y 2vy + z 2vz), each product and sum a
    rounded operation of its own (no matrix product, so no TF32)."""
    v_sq = verts[:, 0] * verts[:, 0] + verts[:, 1] * verts[:, 1] \
        + verts[:, 2] * verts[:, 2]
    v2 = 2.0 * verts
    out = []
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        dot2 = p[:, 0:1] * v2[:, 0] + p[:, 1:2] * v2[:, 1] \
            + p[:, 2:3] * v2[:, 2]
        out.append(torch.argmin(v_sq - dot2, dim=-1))
    if not out:
        return torch.zeros((0,), dtype=torch.long, device=points.device)
    return torch.cat(out)


def _split_write_back(base: torch.Tensor, idx: torch.Tensor,
                      new: torch.Tensor) -> torch.Tensor:
    """base with rows idx (distinct) replaced by new (one row each)."""
    out = base.clone()
    out[idx] = new
    return out


def _resolve_idx(active: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first `cap` active rows (the phase-2 batch)."""
    return torch.nonzero(active).flatten()[:cap]


def _nn_backward_map(points_world, smpl: SmplRef, frame: CanonicalFrame):
    """Nearest-SMPL-vertex backward skinning: world points -> canonical.
    Returns (x_hat_metric, x_hat_norm, T_fwd)."""
    idx = nn_idx(points_world, smpl.verts_posed)
    w = smpl.skinning_weights[idx]
    T_fwd = torch.einsum('nj,jab->nab', w, frame.bone_transforms)
    T_bwd = inv_affine(T_fwd)
    x_hat = apply_transform(T_bwd, points_world - frame.trans)
    x_norm = normalize_canonical_points(
        x_hat, frame.coord_min, frame.coord_max, frame.center)
    return x_hat, x_norm, T_fwd


class MarchCarry(NamedTuple):
    t: torch.Tensor             # (N,) marching depth
    unfinished: torch.Tensor    # (N,)
    diverged: torch.Tensor      # (N,)
    x_norm: torch.Tensor        # (N, 3) latest canonical estimate
    T_fwd: torch.Tensor         # (N, 4, 4)


def _march(cfg: RayTracerConfig, sdf_fn: Callable, frame: CanonicalFrame,
           smpl: SmplRef, cam_loc, ray_dirs, near, far) -> MarchCarry:
    """The sphere-trace march loop, with an early exit once no ray is
    unfinished (the body is a no-op on finished rays)."""
    thresh = cfg.root_finding_threshold
    n = ray_dirs.shape[0]
    dev = ray_dirs.device
    c = MarchCarry(near, near < far, near >= far,
                   torch.zeros((n, 3), device=dev),
                   torch.zeros((n, 4, 4), device=dev))
    big = torch.tensor(1e11, device=dev)
    i = 0
    while i < cfg.sphere_tracing_iters and bool(c.unfinished.any()):
        pts = cam_loc + c.t[:, None] * ray_dirs
        _, x_norm, T_fwd = _nn_backward_map(pts, smpl, frame)
        sdf = sdf_to_metric(sdf_fn(x_norm), frame.coord_min,
                            frame.coord_max)
        sdf = torch.where(c.unfinished, sdf, big)
        x_norm_new = torch.where(c.unfinished[:, None], x_norm, c.x_norm)
        T_new = torch.where(c.unfinished[:, None, None], T_fwd, c.T_fwd)
        sdf_march = torch.clamp(sdf, -cfg.clamp_dist, cfg.clamp_dist)
        update = (torch.abs(sdf_march) > thresh) & (torch.abs(sdf) < 1e6)
        t = torch.where(update, c.t + sdf_march, c.t)
        diverged = torch.where(update, t >= far, c.diverged)
        remove = (c.unfinished & (torch.abs(sdf) <= thresh)) | diverged
        c = MarchCarry(t, c.unfinished & ~remove, diverged, x_norm_new,
                       T_new)
        i += 1
    return c


def _march_split(cfg: RayTracerConfig, sdf_fn: Callable,
                 frame: CanonicalFrame, smpl: SmplRef, cam_loc, ray_dirs,
                 near, far) -> MarchCarry:
    """Straggler-resolve split of the march: phase 1 caps every ray at
    `march_phase1_steps`; the first `march_resolve_cap` still-unfinished
    rays then resume from their depth with the remaining budget."""
    p1 = cfg.march_phase1_steps
    if p1 <= 0 or p1 >= cfg.sphere_tracing_iters:
        return _march(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near, far)
    c1 = _march(cfg._replace(sphere_tracing_iters=p1), sdf_fn, frame, smpl,
                cam_loc, ray_dirs, near, far)
    idx = _resolve_idx(c1.unfinished, cfg.march_resolve_cap)
    if idx.numel() == 0:
        return c1
    c2 = _march(cfg._replace(sphere_tracing_iters=cfg.sphere_tracing_iters
                             - p1), sdf_fn, frame, smpl, cam_loc[idx],
                ray_dirs[idx], c1.t[idx], far[idx])
    return MarchCarry(*(_split_write_back(a, idx, b)
                        for a, b in zip(c1, c2)))


def sphere_trace(cfg: RayTracerConfig, sdf_fn: Callable, skin_fn: Callable,
                 frame: CanonicalFrame, smpl: SmplRef, cam_loc, ray_dirs,
                 near, far, eval_mode: bool = False) -> SphereTraceResult:
    """KNN-skinning sphere tracing + joint root-finding refinement.
    cam_loc: (N, 3) per-ray origins; ray_dirs (N, 3); near/far (N,)."""
    thresh = cfg.root_finding_threshold

    def _iso_solve(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd, max_steps):
        return search_iso_surface_depth(
            sdf_fn, skin_fn, frame, cam_loc, ray_dirs, valid, x_hat, z0,
            T_fwd, max_steps=max_steps, cvg_thresh=thresh)

    def _iso(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd):
        p1 = cfg.iso_phase1_steps
        if p1 <= 0 or p1 >= cfg.iso_max_steps:
            return _iso_solve(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd,
                              cfg.iso_max_steps)
        r1 = _iso_solve(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd, p1)
        idx = _resolve_idx(r1.active, cfg.iso_resolve_cap)
        if idx.numel() == 0:
            return r1._replace(active=torch.zeros_like(r1.active))
        r2 = _iso_solve(cam_loc[idx], ray_dirs[idx],
                        torch.ones_like(idx, dtype=torch.bool), x_hat[idx],
                        z0[idx], T_fwd[idx], cfg.iso_max_steps)
        return r1._replace(
            **{k: _split_write_back(getattr(r1, k), idx, getattr(r2, k))
               for k in r1._fields[:4]},
            active=torch.zeros_like(r1.active))

    n = ray_dirs.shape[0]
    c = _march_split(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near, far)
    x_hat = unnormalize_canonical_points(
        c.x_norm, frame.coord_min, frame.coord_max, frame.center)
    valid = ~c.diverged if eval_mode \
        else torch.ones((n,), dtype=torch.bool, device=ray_dirs.device)
    iso = _iso(cam_loc, ray_dirs, valid, x_hat, c.t, c.T_fwd)
    converged = iso.converged & (iso.z_depth >= near) & (iso.z_depth <= far)
    t_out = torch.where(converged, iso.z_depth, near)
    x_out_norm = normalize_canonical_points(
        iso.x_hat, frame.coord_min, frame.coord_max, frame.center)
    return SphereTraceResult(x_out_norm, iso.T_fwd, ~converged, t_out, far)


class SamplerResult(NamedTuple):
    z_vals: torch.Tensor          # (N, S) sorted sample depths
    sample_mask: torch.Tensor     # (N, S) active-sample mask
    points_norm: torch.Tensor     # (N, S, 3) canonical samples
    transforms: torch.Tensor      # (N, S, 4, 4) forward transforms
    converge_mask: torch.Tensor   # (N, S) root-finding convergence


def jitter_shapes(cfg: RayTracerConfig, n_rays: int):
    """Shapes of the three uniform draws of training-mode sampling: the
    base samples, the near-surface and the far-surface samples."""
    return ((n_rays, cfg.n_steps),
            (n_rays, cfg.near_surface_vol_samples + 1),
            (n_rays, max(cfg.far_surface_vol_samples, 1)))


def sample_z_vals(cfg: RayTracerConfig, body_mask, surface_depth, near, far,
                  eval_mode: bool = True, jitter=None):
    """Per-ray depth samples + activity mask: 64 samples on rays that
    missed the body; on body rays 16+1 near-surface and 16 far-surface
    samples (sorted), the remaining slots masked off; a ray that misses
    the box (near >= far) has every slot masked off. Training jitters
    each group within its intervals with the uniform draws `jitter` =
    (u1, u2, u3), the near-surface group's middle sample pinned to the
    surface."""
    n = body_mask.shape[0]
    dev = surface_depth.device
    S = cfg.n_steps
    ns, fs = cfg.near_surface_vol_samples, cfg.far_surface_vol_samples
    rng_lin = torch.linspace(0.0, 1.0, S, device=dev)
    z0 = surface_depth[:, None] + (far - surface_depth)[:, None] * rng_lin
    if not eval_mode:
        z0 = stratified_z_vals(z0, jitter[0])
    mask = torch.ones((n, S), dtype=torch.bool, device=dev)
    hit = (near < far)[:, None]
    lin_ns = torch.linspace(0.0, 1.0, ns + 1, device=dev)
    z_near = (surface_depth[:, None] - cfg.surface_vol_range
              + 2.0 * cfg.surface_vol_range * lin_ns)
    if not eval_mode:
        z_near = stratified_z_vals(z_near, jitter[1], fix_idx=ns // 2)
    lin_fs = torch.linspace(0.0, 1.0, max(fs, 1), device=dev)
    span = torch.clamp(surface_depth - cfg.surface_vol_range - near,
                       min=1e-5)
    z_far = near[:, None] + span[:, None] * lin_fs
    if not eval_mode:
        z_far = stratified_z_vals(z_far, jitter[2])
    surf = torch.sort(torch.cat([z_near, z_far], dim=-1), dim=-1)[0]
    n_surf = ns + 1 + fs
    z_body = torch.cat([surf, z0[:, n_surf:]], dim=-1)
    mask_body = (torch.arange(S, device=dev) < n_surf)[None, :]
    z = torch.where(body_mask[:, None], z_body, z0)
    mask = torch.where(body_mask[:, None], mask_body, mask)
    return z, mask & hit


def _corr_solve(cfg: RayTracerConfig, skin_fn: Callable,
                frame: CanonicalFrame, x_bar, x0, T0, mask,
                max_steps: int | None = None):
    """Flat canonical-correspondence solve by the dense Broyden: (x_hat
    (N, 3), T_fwd (N, 4, 4), valid (N,), active (N,))."""
    res = search_canonical_corr(
        skin_fn, frame, x_bar, x0, T0,
        max_steps=cfg.corr_max_steps if max_steps is None else max_steps,
        cvg_thresh=cfg.root_finding_threshold, active_init=mask)
    return res.x_hat, res.T_fwd, res.valid & mask, res.active


def _corr_solve_split(cfg: RayTracerConfig, skin_fn: Callable,
                      frame: CanonicalFrame, x_bar, x0, T0, mask):
    """Straggler-resolve split of the corr solve: phase 1 caps every
    point at `corr_phase1_steps`; the first `corr_resolve_cap` still-active
    points are solved again from scratch at `corr_max_steps`, and only
    their rows are written back. Actives beyond the cap keep their
    phase-1 result."""
    p1 = cfg.corr_phase1_steps
    if p1 <= 0 or p1 >= cfg.corr_max_steps:
        return _corr_solve(cfg, skin_fn, frame, x_bar, x0, T0, mask)
    x1, T1, v1, act = _corr_solve(cfg, skin_fn, frame, x_bar, x0, T0, mask,
                                  max_steps=p1)
    idx = _resolve_idx(act, cfg.corr_resolve_cap)
    if idx.numel() == 0:
        return x1, T1, v1, torch.zeros_like(act)
    x2, T2, v2, _ = _corr_solve(
        cfg, skin_fn, frame, x_bar[idx], x0[idx], T0[idx],
        torch.ones_like(idx, dtype=torch.bool))
    return (_split_write_back(x1, idx, x2), _split_write_back(T1, idx, T2),
            _split_write_back(v1, idx, v2), torch.zeros_like(act))


def corr_init(frame: CanonicalFrame, smpl: SmplRef, pts_world):
    """Nearest-vertex init of the correspondence search: (x_bar (N, 3)
    target without translation, x0 (N, 3) init, T0 (N, 4, 4) init
    transform) of world points (N, 3)."""
    idx = nn_idx(pts_world, smpl.verts_posed)
    T0 = torch.einsum('nj,jab->nab', smpl.skinning_weights[idx],
                      frame.bone_transforms)
    x_bar = pts_world - frame.trans
    x0 = apply_transform(inv_affine(T0), x_bar)
    return x_bar.contiguous(), x0.contiguous(), T0


def canonicalize_samples(cfg: RayTracerConfig, skin_fn: Callable,
                         frame: CanonicalFrame, smpl: SmplRef, cam_loc,
                         ray_dirs, z_vals, sample_mask):
    """Backward-map all ray samples to canonical space: nearest-vertex
    init, then the Broyden correspondence search; masked samples are
    frozen and report converge=False. Returns (points_norm (n, S, 3),
    T_fwd (n, S, 4, 4), converged (n, S))."""
    n, S = z_vals.shape
    pts_world = (cam_loc[:, None, :] + z_vals[..., None]
                 * ray_dirs[:, None, :]).reshape(-1, 3).contiguous()
    flat_mask = sample_mask.reshape(-1).contiguous()
    x_bar, x0, T0 = corr_init(frame, smpl, pts_world)
    x_hat, T_fwd, valid, _ = _corr_solve_split(cfg, skin_fn, frame, x_bar,
                                               x0, T0, flat_mask)
    x_norm = normalize_canonical_points(
        x_hat, frame.coord_min, frame.coord_max, frame.center)
    return (x_norm.reshape(n, S, 3), T_fwd.reshape(n, S, 4, 4),
            (valid & flat_mask).reshape(n, S))


class TraceOutput(NamedTuple):
    surface: SphereTraceResult
    samples: SamplerResult


def trace_and_sample(cfg: RayTracerConfig, sdf_fn: Callable,
                     skin_fn: Callable, frame: CanonicalFrame, smpl: SmplRef,
                     cam_loc, ray_dirs, near, far, eval_mode: bool = True,
                     jitter=None) -> TraceOutput:
    """Sphere trace + sample + canonicalize (no gradients). Training
    (`eval_mode=False`) keeps every ray valid at the iso refinement and
    jitters the samples with `jitter` (see `sample_z_vals`)."""
    surf = sphere_trace(cfg, sdf_fn, skin_fn, frame, smpl, cam_loc,
                        ray_dirs, near, far, eval_mode=eval_mode)
    z_vals, sample_mask = sample_z_vals(cfg, ~surf.unconverged,
                                        surf.start_dis, near, far, eval_mode,
                                        jitter)
    out = canonicalize_samples(cfg, skin_fn, frame, smpl, cam_loc, ray_dirs,
                               z_vals, sample_mask)
    return TraceOutput(surf, SamplerResult(z_vals, sample_mask, *out))
