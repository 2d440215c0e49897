"""Dense ray tracer for articulated human SDFs (eval and training).
Port of `arah_tpu/render/ray_tracing.py`: KNN-skinning sphere tracing,
joint (canonical point, depth) root-finding refinement, near/far-surface
sampling, and the canonical-correspondence search of every ray sample —
with dense fixed-shape blocks and convergence masks carried as data.

Kernels on this path (`ops/`): the fused march (kernel E, when
`use_pallas_march` and the renderer hands over the generated SIREN), the
iso refinement (kernel F, when `use_pallas_iso` with the generated SIREN
and the collapsed skinning MLP), the nearest-vertex query (kernel A) in
`canonicalize_samples` and the corr Broyden (kernel B). With a kernel's
flag off its plain loop runs (`_march_plain`, the counterpart of
`_march_xla`; `search_iso_surface_depth`); with the flag on, a CUDA
tensor and no network to hand the kernel, the dispatch raises. The kernels
take any number of rays, so no tile-divisibility guard (JAX's `n % tile`)
sends a ragged phase-2 batch to a plain loop.

The straggler-resolve splits write phase 2's results back to exactly the
rows phase 2 solved (`_split_write_back`). The JAX package pads its index
list with 0 and scatters the padded rows too, which can leave row 0 with
its stale phase-1 value; the port does not reproduce that.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from arah_tpu_torch.core.body import (apply_transform,
                                      normalize_canonical_points,
                                      sdf_to_metric,
                                      unnormalize_canonical_points)
from arah_tpu_torch.core.linalg import inv_affine
from arah_tpu_torch.core.rays import stratified_z_vals
from arah_tpu_torch.ops.corr import corr_search
from arah_tpu_torch.ops.iso import iso_refine
from arah_tpu_torch.ops.knn import nn_idx, nn_idx_plain
from arah_tpu_torch.ops.march import sphere_march
from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                             IsoSurfaceResult,
                                             iso_init_inv_jacobian,
                                             search_canonical_corr,
                                             search_iso_surface_depth)


class RayTracerConfig(NamedTuple):
    """Field for field the JAX `RayTracerConfig`, with its defaults.

    `corr_chunk`, `trace_chunk` and `corr_coarse_stride` are scheduling
    options of the JAX package (value-identical chunkings, and an A/B
    warm start); the port keeps the fields and always solves densely.
    `pallas_*_tile` and `pallas_precision` size and tune the TPU kernels
    and are not read here, except that the corr kernel takes only
    precision 'f32'.
    """
    root_finding_threshold: float = 1e-5
    sphere_tracing_iters: int = 50
    n_steps: int = 64
    near_surface_vol_samples: int = 16
    far_surface_vol_samples: int = 16
    surface_vol_range: float = 0.05
    clamp_dist: float = 0.1
    corr_max_steps: int = 50
    iso_max_steps: int = 50
    corr_chunk: int = 16384
    trace_chunk: int = 0
    use_pallas_corr: bool = True
    pallas_corr_tile: int = 2048
    pallas_precision: str = 'f32'
    use_pallas_march: bool = True
    pallas_march_tile: int = 256
    corr_coarse_stride: int = 0
    corr_warm_gate: float = 0.1
    corr_phase1_steps: int = 0
    corr_resolve_cap: int = 4096
    march_phase1_steps: int = 0
    march_resolve_cap: int = 512
    iso_phase1_steps: int = 0
    iso_resolve_cap: int = 512
    use_pallas_knn: bool = True
    pallas_knn_tile: int = 2048
    use_pallas_iso: bool = True
    pallas_iso_tile: int = 512


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


def _knn(cfg: RayTracerConfig, points, verts):
    """Nearest posed vertex: kernel A when `use_pallas_knn`."""
    if cfg.use_pallas_knn:
        return nn_idx(points, verts)
    return nn_idx_plain(points, verts)


def _split_write_back(base: torch.Tensor, idx: torch.Tensor,
                      new: torch.Tensor) -> torch.Tensor:
    """base with rows idx (distinct) replaced by new (one row each)."""
    out = base.clone()
    out[idx] = new
    return out


def _resolve_idx(active: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first `cap` active rows (the phase-2 batch)."""
    return torch.nonzero(active).flatten()[:cap]


def _nn_backward_map(cfg: RayTracerConfig, points_world, smpl: SmplRef,
                     frame: CanonicalFrame):
    """Nearest-SMPL-vertex backward skinning: world points -> canonical.
    Returns (x_hat_metric, x_hat_norm, T_fwd)."""
    idx = _knn(cfg, points_world, smpl.verts_posed).long()
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


def _march_plain(cfg: RayTracerConfig, sdf_fn: Callable,
                 frame: CanonicalFrame, smpl: SmplRef, cam_loc, ray_dirs,
                 near, far) -> MarchCarry:
    """The sphere-trace march loop (port of `_march_xla`), with an early
    exit once no ray is unfinished (a no-op body on finished rays)."""
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
        _, x_norm, T_fwd = _nn_backward_map(cfg, pts, smpl, frame)
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


def _march(cfg: RayTracerConfig, sdf_fn: Callable, frame: CanonicalFrame,
           smpl: SmplRef, cam_loc, ray_dirs, near, far,
           sdf_gen=None) -> MarchCarry:
    """March-loop dispatch: kernel E when `use_pallas_march` and the
    generated SIREN (sdf_gen) is given, the plain loop otherwise."""
    if cfg.use_pallas_march and sdf_gen is not None:
        n = ray_dirs.shape[0]
        t, unf, div, x_norm, T16 = sphere_march(
            cam_loc.contiguous(), ray_dirs.contiguous(), near.contiguous(),
            far.contiguous(), smpl.verts_posed, smpl.skinning_weights,
            frame, sdf_gen, n_iters=cfg.sphere_tracing_iters,
            thresh=cfg.root_finding_threshold, clamp_dist=cfg.clamp_dist)
        return MarchCarry(t, unf, div, x_norm, T16.reshape(n, 4, 4))
    if cfg.use_pallas_march and ray_dirs.is_cuda:
        raise ValueError('use_pallas_march: the march kernel needs the '
                         'generated SIREN (sdf_gen)')
    return _march_plain(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near,
                        far)


def _march_split(cfg: RayTracerConfig, sdf_fn: Callable,
                 frame: CanonicalFrame, smpl: SmplRef, cam_loc, ray_dirs,
                 near, far, sdf_gen=None) -> MarchCarry:
    """Straggler-resolve split of the march: phase 1 caps every ray at
    `march_phase1_steps`; the first `march_resolve_cap` still-unfinished
    rays then resume from their depth with the remaining budget."""
    p1 = cfg.march_phase1_steps
    if p1 <= 0 or p1 >= cfg.sphere_tracing_iters:
        return _march(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near, far,
                      sdf_gen)
    c1 = _march(cfg._replace(sphere_tracing_iters=p1), sdf_fn, frame, smpl,
                cam_loc, ray_dirs, near, far, sdf_gen)
    idx = _resolve_idx(c1.unfinished, cfg.march_resolve_cap)
    if idx.numel() == 0:
        return c1
    c2 = _march(cfg._replace(sphere_tracing_iters=cfg.sphere_tracing_iters
                             - p1), sdf_fn, frame, smpl, cam_loc[idx],
                ray_dirs[idx], c1.t[idx], far[idx], sdf_gen)
    return MarchCarry(*(_split_write_back(a, idx, b)
                        for a, b in zip(c1, c2)))


def sphere_trace(cfg: RayTracerConfig, sdf_fn: Callable, skin_fn: Callable,
                 frame: CanonicalFrame, smpl: SmplRef, cam_loc, ray_dirs,
                 near, far, eval_mode: bool = False, sdf_gen=None,
                 skin_dense=None) -> SphereTraceResult:
    """KNN-skinning sphere tracing + joint root-finding refinement.
    cam_loc: (N, 3) per-ray origins; ray_dirs (N, 3); near/far (N,);
    sdf_gen: the generated SIREN (kernels E and F); skin_dense: the
    collapsed skinning MLP (wts, bs, softmax_scale) (kernel F)."""
    thresh = cfg.root_finding_threshold

    def _iso_solve(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd, max_steps):
        if cfg.use_pallas_iso and sdf_gen is not None \
                and skin_dense is not None:
            n = ray_dirs.shape[0]
            J_inv0 = iso_init_inv_jacobian(sdf_fn, skin_fn, frame, ray_dirs,
                                           x_hat)
            u0 = torch.cat([x_hat, z0[:, None]], dim=-1)
            wts, bs, softmax_scale = skin_dense
            u, T16, ok, act = iso_refine(
                cam_loc.contiguous(), ray_dirs.contiguous(), u0,
                T_fwd.reshape(n, 16).contiguous(),
                J_inv0.reshape(n, 16).contiguous(), valid.contiguous(), wts,
                bs, frame, sdf_gen, max_steps=max_steps, cvg_thresh=thresh,
                softmax_scale=softmax_scale)
            return IsoSurfaceResult(u[:, :3], u[:, 3], T16.reshape(n, 4, 4),
                                    ok, act)
        if cfg.use_pallas_iso and ray_dirs.is_cuda:
            raise ValueError('use_pallas_iso: the iso kernel needs the '
                             'generated SIREN (sdf_gen) and a collapsible '
                             'skinning MLP (skin_dense)')
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
        return IsoSurfaceResult(
            *(_split_write_back(a, idx, b) for a, b in zip(r1[:4], r2[:4])),
            active=torch.zeros_like(r1.active))

    n = ray_dirs.shape[0]
    c = _march_split(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near, far,
                     sdf_gen)
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
    samples (sorted), the remaining slots masked off. Training
    (`eval_mode=False`) jitters each group within its intervals with the
    given uniform draws `jitter` = (u1, u2, u3) of `jitter_shapes`, the
    near-surface group's middle sample pinned to the surface."""
    if not eval_mode and jitter is None:
        raise ValueError('training-mode sampling takes its uniform draws '
                         '(jitter)')
    n = body_mask.shape[0]
    dev = surface_depth.device
    S = cfg.n_steps
    ns, fs = cfg.near_surface_vol_samples, cfg.far_surface_vol_samples
    rng_lin = torch.linspace(0.0, 1.0, S, device=dev)
    z0 = surface_depth[:, None] + (far - surface_depth)[:, None] * rng_lin
    if not eval_mode:
        z0 = stratified_z_vals(z0, jitter[0])
    mask = torch.ones((n, S), dtype=torch.bool, device=dev)
    if ns > 0 or fs > 0:
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
        return z, mask
    return z0, mask


def _corr_solve(cfg: RayTracerConfig, skin_fn: Callable,
                frame: CanonicalFrame, skin_dense, x_bar, x0, T0, mask,
                max_steps: int | None = None):
    """Flat canonical-correspondence solve: kernel B when
    `use_pallas_corr`, the dense plain Broyden otherwise. Returns
    (x_hat (N, 3), T_fwd (N, 4, 4), valid (N,), active (N,))."""
    n = x_bar.shape[0]
    if max_steps is None:
        max_steps = cfg.corr_max_steps
    if cfg.use_pallas_corr:
        if skin_dense is None:
            if x_bar.is_cuda:
                raise NotImplementedError(
                    'the corr kernel takes a plain skinning MLP (no PE, '
                    'skips or cond inputs); set use_pallas_corr=False')
        else:
            wts, bs, softmax_scale = skin_dense
            x_hat, T16, valid, active = corr_search(
                x_bar, x0, T0.reshape(n, 16).contiguous(), mask, wts, bs,
                frame.bone_transforms.reshape(24, 16).contiguous(),
                frame.coord_min, frame.coord_max, frame.center,
                max_steps=max_steps, cvg_thresh=cfg.root_finding_threshold,
                softmax_scale=softmax_scale,
                precision=cfg.pallas_precision)
            return x_hat, T16.reshape(n, 4, 4), valid & mask, active
    res = search_canonical_corr(skin_fn, frame, x_bar, x0, T0,
                                max_steps=max_steps,
                                cvg_thresh=cfg.root_finding_threshold,
                                active_init=mask)
    return res.x_hat, res.T_fwd, res.valid & mask, res.active


def _corr_solve_split(cfg: RayTracerConfig, skin_fn: Callable,
                      frame: CanonicalFrame, skin_dense, x_bar, x0, T0,
                      mask):
    """Straggler-resolve split of the corr solve: phase 1 caps every point
    at `corr_phase1_steps`; the first `corr_resolve_cap` still-active
    points are re-solved from scratch at `corr_max_steps` (a point's
    trajectory does not depend on the others), and only their rows are
    written back. Actives beyond the cap keep their phase-1 result."""
    p1 = cfg.corr_phase1_steps
    if p1 <= 0 or p1 >= cfg.corr_max_steps:
        return _corr_solve(cfg, skin_fn, frame, skin_dense, x_bar, x0, T0,
                           mask)
    x1, T1, v1, act = _corr_solve(cfg, skin_fn, frame, skin_dense, x_bar,
                                  x0, T0, mask, max_steps=p1)
    idx = _resolve_idx(act, cfg.corr_resolve_cap)
    if idx.numel() == 0:
        return x1, T1, v1, torch.zeros_like(act)
    x2, T2, v2, _ = _corr_solve(cfg, skin_fn, frame, skin_dense, x_bar[idx],
                                x0[idx], T0[idx],
                                torch.ones_like(idx, dtype=torch.bool))
    return (_split_write_back(x1, idx, x2), _split_write_back(T1, idx, T2),
            _split_write_back(v1, idx, v2), torch.zeros_like(act))


def corr_init(cfg: RayTracerConfig, frame: CanonicalFrame, smpl: SmplRef,
              pts_world):
    """Nearest-vertex init of the correspondence search (kernel A):
    (x_bar (N, 3) target without translation, x0 (N, 3) init, T0
    (N, 4, 4) init transform) of world points (N, 3)."""
    idx = _knn(cfg, pts_world, smpl.verts_posed).long()
    T0 = torch.einsum('nj,jab->nab', smpl.skinning_weights[idx],
                      frame.bone_transforms)
    x_bar = pts_world - frame.trans
    x0 = apply_transform(inv_affine(T0), x_bar)
    return x_bar.contiguous(), x0.contiguous(), T0


def canonicalize_samples(cfg: RayTracerConfig, skin_fn: Callable,
                         frame: CanonicalFrame, smpl: SmplRef, cam_loc,
                         ray_dirs, z_vals, sample_mask, skin_dense=None):
    """Backward-map all ray samples to canonical space: nearest-vertex
    init (kernel A) then the Broyden correspondence search (kernel B);
    masked samples are frozen and report converge=False."""
    n, S = z_vals.shape
    pts_world = (cam_loc[:, None, :] + z_vals[..., None]
                 * ray_dirs[:, None, :]).reshape(-1, 3).contiguous()
    flat_mask = sample_mask.reshape(-1).contiguous()
    x_bar, x0, T0 = corr_init(cfg, frame, smpl, pts_world)
    x_hat, T_fwd, valid, _ = _corr_solve_split(
        cfg, skin_fn, frame, skin_dense, x_bar, x0, T0, flat_mask)
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
                     skin_dense=None, sdf_gen=None,
                     jitter=None) -> TraceOutput:
    """Sphere trace + sample + canonicalize (no gradients). Training
    (`eval_mode=False`) keeps every ray valid at the iso refinement and
    jitters the samples with `jitter` (see `sample_z_vals`)."""
    surf = sphere_trace(cfg, sdf_fn, skin_fn, frame, smpl, cam_loc,
                        ray_dirs, near, far, eval_mode=eval_mode,
                        sdf_gen=sdf_gen, skin_dense=skin_dense)
    z_vals, sample_mask = sample_z_vals(cfg, ~surf.unconverged,
                                        surf.start_dis, near, far, eval_mode,
                                        jitter)
    pts, tfs, cvg = canonicalize_samples(cfg, skin_fn, frame, smpl, cam_loc,
                                         ray_dirs, z_vals, sample_mask,
                                         skin_dense=skin_dense)
    return TraceOutput(surf, SamplerResult(z_vals, sample_mask, pts, tfs,
                                           cvg))
