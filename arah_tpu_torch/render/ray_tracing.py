"""Dense ray tracer for articulated human SDFs (eval and training).
Port of `arah_tpu/render/ray_tracing.py`: KNN-skinning sphere tracing,
joint (canonical point, depth) root-finding refinement, near/far-surface
sampling, and the canonical-correspondence search of every ray sample —
with dense fixed-shape blocks and convergence masks carried as data.

Kernels on this path (`ops/`): the fused march (kernel E, when
`use_pallas_march` and the renderer hands over the generated SIREN), the
iso refinement (kernel F, when `use_pallas_iso` with the generated SIREN
and the collapsed skinning MLP, started from the inverse init Jacobian
that `ops/iso_init.py` computes in one launch a solve), the corr init's
nearest-vertex query (kernel A, when `use_pallas_knn`) and the corr
Broyden (kernel B). With a kernel's flag off its plain loop runs
(`_march_plain`, the counterpart of `_march_xla`;
`search_iso_surface_depth`); with the flag on, a CUDA
tensor and no network to hand the kernel, the dispatch raises. Every
other nearest-vertex query (the plain march's, and the corr init's with
`use_pallas_knn` off) is `ops/fused.py:fused_nn_idx`, and the plain loops
evaluate the SDF the renderer hands them: under `ARAH_ENABLE_PALLAS=1`
these are kernels K and J, as in JAX. The kernels take any number of
rays, so no tile-divisibility guard (JAX's `n % tile`) sends a ragged
phase-2 batch to a plain loop.

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
from arah_tpu_torch.ops.corr import corr_search, pack_corr
from arah_tpu_torch.ops.fused import fused_nn_idx
from arah_tpu_torch.ops.iso import iso_refine
from arah_tpu_torch.ops.iso_init import iso_init
from arah_tpu_torch.ops.knn import nn_idx
from arah_tpu_torch.ops.march import pack_trace, sphere_march
from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                             IsoSurfaceResult,
                                             search_canonical_corr,
                                             search_iso_surface_depth)
from arah_tpu_torch.utils import trace


class RayTracerConfig(NamedTuple):
    """Field for field the JAX `RayTracerConfig`, with its defaults.

    `corr_chunk` and `trace_chunk` are value-identical chunkings of the
    JAX package; the port keeps the fields and always solves densely.
    `corr_coarse_stride` > 1 runs the coarse-to-fine warm start of
    `canonicalize_samples`, as in JAX (different roots from 0, within
    solver tolerance). `pallas_*_tile` size the TPU kernels and are not
    read here; `pallas_precision` is the corr kernel's (B's products,
    'f32', 'split3' or 'bf16', on the card and in its plain version).
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
    """The corr init's nearest posed vertex: kernel A when
    `use_pallas_knn`, else `fused_nn_idx`."""
    if cfg.use_pallas_knn:
        return nn_idx(points, verts)
    return fused_nn_idx(points, verts)


def _split_write_back(base: torch.Tensor, idx: torch.Tensor,
                      new: torch.Tensor) -> torch.Tensor:
    """base with rows idx (distinct) replaced by new (one row each)."""
    out = base.clone()
    out[idx] = new
    return out


def _resolve_idx(active: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first `cap` active rows (the phase-2 batch): the
    host waits for the device's count (`tracer.sync.resolve`)."""
    with trace.sync('tracer.sync.resolve'):
        return torch.nonzero(active).flatten()[:cap]


def _nn_backward_map(points_world, smpl: SmplRef, frame: CanonicalFrame):
    """Nearest-SMPL-vertex backward skinning: world points -> canonical.
    Returns (x_hat_metric, x_hat_norm, T_fwd)."""
    idx = fused_nn_idx(points_world, smpl.verts_posed).long()
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


def _march(cfg: RayTracerConfig, sdf_fn: Callable, frame: CanonicalFrame,
           smpl: SmplRef, cam_loc, ray_dirs, near, far,
           sdf_gen=None, packed=None) -> MarchCarry:
    """March-loop dispatch: kernel E when `use_pallas_march` and the
    generated SIREN (sdf_gen; `packed` its `pack_trace`) is given, the
    plain loop otherwise."""
    if cfg.use_pallas_march and sdf_gen is not None:
        n = ray_dirs.shape[0]
        t, unf, div, x_norm, T16 = sphere_march(
            cam_loc.contiguous(), ray_dirs.contiguous(), near.contiguous(),
            far.contiguous(), smpl.verts_posed, smpl.skinning_weights,
            frame, sdf_gen, n_iters=cfg.sphere_tracing_iters,
            thresh=cfg.root_finding_threshold, clamp_dist=cfg.clamp_dist,
            packed=packed)
        return MarchCarry(t, unf, div, x_norm, T16.reshape(n, 4, 4))
    if cfg.use_pallas_march and ray_dirs.is_cuda:
        raise ValueError('use_pallas_march: the march kernel needs the '
                         'generated SIREN (sdf_gen)')
    return _march_plain(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near,
                        far)


def _march_split(cfg: RayTracerConfig, sdf_fn: Callable,
                 frame: CanonicalFrame, smpl: SmplRef, cam_loc, ray_dirs,
                 near, far, sdf_gen=None, packed=None) -> MarchCarry:
    """Straggler-resolve split of the march: phase 1 caps every ray at
    `march_phase1_steps`; the first `march_resolve_cap` still-unfinished
    rays then resume from their depth with the remaining budget."""
    p1 = cfg.march_phase1_steps
    if p1 <= 0 or p1 >= cfg.sphere_tracing_iters:
        with trace.span('tracer.march.p1'):
            return _march(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near,
                          far, sdf_gen, packed)
    with trace.span('tracer.march.p1'):
        c1 = _march(cfg._replace(sphere_tracing_iters=p1), sdf_fn, frame,
                    smpl, cam_loc, ray_dirs, near, far, sdf_gen, packed)
    idx = _resolve_idx(c1.unfinished, cfg.march_resolve_cap)
    if idx.numel() == 0:
        return c1
    with trace.span('tracer.march.p2'):
        c2 = _march(cfg._replace(sphere_tracing_iters=cfg.sphere_tracing_iters
                                 - p1), sdf_fn, frame, smpl, cam_loc[idx],
                    ray_dirs[idx], c1.t[idx], far[idx], sdf_gen, packed)
    with trace.span('tracer.march.write_back'):
        return MarchCarry(*(_split_write_back(a, idx, b)
                            for a, b in zip(c1, c2)))


def trace_pack(cfg: RayTracerConfig, sdf_gen=None, skin_dense=None):
    """The one parameter pack of a trace's kernels, built once for every
    phase of E, F and B: `ops/march.py:pack_trace` of the generated SIREN
    (E and F) and, where F or B runs, of the collapsed skinning MLP (B
    reads its skinning blocks); B's own `pack_corr` where there is no
    SIREN; None where no kernel reads one."""
    skin = skin_dense is not None and (cfg.use_pallas_iso
                                       or cfg.use_pallas_corr)
    if sdf_gen is not None and (skin or cfg.use_pallas_march):
        return pack_trace(sdf_gen, *(skin_dense[:2] if skin else ()))
    if skin and cfg.use_pallas_corr:
        return pack_corr(skin_dense[0], skin_dense[1])
    return None


def corr_pack(cfg: RayTracerConfig, skin_dense, packed):
    """Kernel B's pack: the trace's `packed` at precision 'f32', else the
    skinning MLP's own `pack_corr` at `cfg.pallas_precision` (its weight
    halves made once a trace); None where B does not run."""
    if not cfg.use_pallas_corr or skin_dense is None:
        return None
    if cfg.pallas_precision == 'f32':
        return packed
    return pack_corr(skin_dense[0], skin_dense[1], cfg.pallas_precision)


def sphere_trace(cfg: RayTracerConfig, sdf_fn: Callable, skin_fn: Callable,
                 frame: CanonicalFrame, smpl: SmplRef, cam_loc, ray_dirs,
                 near, far, eval_mode: bool = False, sdf_gen=None,
                 skin_dense=None, packed=None) -> SphereTraceResult:
    """KNN-skinning sphere tracing + joint root-finding refinement.
    cam_loc: (N, 3) per-ray origins; ray_dirs (N, 3); near/far (N,);
    sdf_gen: the generated SIREN (kernels E, F and F's init); skin_dense:
    the collapsed skinning MLP (wts, bs, softmax_scale) (F and its init);
    packed: the trace's `trace_pack` (built here when not given)."""
    thresh = cfg.root_finding_threshold
    use_iso = cfg.use_pallas_iso and sdf_gen is not None \
        and skin_dense is not None
    if packed is None:
        packed = trace_pack(cfg, sdf_gen, skin_dense)

    def _iso_solve(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd, max_steps):
        if use_iso:
            n = ray_dirs.shape[0]
            wts, bs, softmax_scale = skin_dense
            ray_dirs = ray_dirs.contiguous()
            with trace.span('tracer.iso.init'):
                J_inv0 = iso_init(x_hat.contiguous(), ray_dirs, wts, bs,
                                  frame, sdf_gen, softmax_scale,
                                  packed=packed)
            trace.count('iso.init')
            u0 = torch.cat([x_hat, z0[:, None]], dim=-1)
            u, T16, ok, act = iso_refine(
                cam_loc.contiguous(), ray_dirs, u0,
                T_fwd.reshape(n, 16).contiguous(), J_inv0,
                valid.contiguous(), wts, bs, frame, sdf_gen,
                max_steps=max_steps, cvg_thresh=thresh,
                softmax_scale=softmax_scale, packed=packed)
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
            with trace.span('tracer.iso.p1'):
                return _iso_solve(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd,
                                  cfg.iso_max_steps)
        with trace.span('tracer.iso.p1'):
            r1 = _iso_solve(cam_loc, ray_dirs, valid, x_hat, z0, T_fwd, p1)
        idx = _resolve_idx(r1.active, cfg.iso_resolve_cap)
        if idx.numel() == 0:
            return r1._replace(active=torch.zeros_like(r1.active))
        with trace.span('tracer.iso.p2'):
            r2 = _iso_solve(cam_loc[idx], ray_dirs[idx],
                            torch.ones_like(idx, dtype=torch.bool),
                            x_hat[idx], z0[idx], T_fwd[idx],
                            cfg.iso_max_steps)
        with trace.span('tracer.iso.write_back'):
            return IsoSurfaceResult(
                *(_split_write_back(a, idx, b)
                  for a, b in zip(r1[:4], r2[:4])),
                active=torch.zeros_like(r1.active))

    n = ray_dirs.shape[0]
    c = _march_split(cfg, sdf_fn, frame, smpl, cam_loc, ray_dirs, near, far,
                     sdf_gen, packed)
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
    jac: torch.Tensor = None      # (N, S, 3, 3) metric d fwd_skin / d x_hat
    #                               at the roots (kernel B's want_jac)


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
    samples (sorted), the remaining slots masked off. A ray that misses
    the box (near >= far) has every slot masked off and composites to
    the background. JAX keeps its slots, whose depths then fall from
    near to far; the negative intervals composite to NaN, which reaches
    the perceptual loss from a patch ray outside the box. Training
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
    hit = (near < far)[:, None]
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
        return z, mask & hit
    return z0, mask & hit


def _corr_solve(cfg: RayTracerConfig, skin_fn: Callable,
                frame: CanonicalFrame, skin_dense, x_bar, x0, T0, mask,
                max_steps: int | None = None, packed=None,
                want_jac: bool = False, phase: str = 'p1'):
    """Flat canonical-correspondence solve: kernel B when
    `use_pallas_corr` (`packed`: the trace's `corr_pack`), the dense
    plain Broyden otherwise. Returns (x_hat (N, 3), T_fwd (N, 4, 4), valid
    (N,), active (N,), jac): jac (N, 3, 3) from B's own launch under
    `want_jac`, None from the plain Broyden (as JAX's XLA solve). While a
    profiler records, the solve's evaluations count under `phase`
    (`utils/trace.py:count_corr`)."""
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
            iters = trace.corr_iters(n, x_bar.device)
            out = corr_search(
                x_bar, x0, T0.reshape(n, 16).contiguous(), mask, wts, bs,
                frame.bone_transforms.reshape(24, 16).contiguous(),
                frame.coord_min, frame.coord_max, frame.center,
                max_steps=max_steps, cvg_thresh=cfg.root_finding_threshold,
                softmax_scale=softmax_scale,
                precision=cfg.pallas_precision, want_jac=want_jac,
                packed=packed, iters=iters)
            trace.count_corr(phase, mask, iters)
            return (out[0], out[1].reshape(n, 4, 4), out[2] & mask, out[3],
                    out[4] if want_jac else None)
    res = search_canonical_corr(skin_fn, frame, x_bar, x0, T0,
                                max_steps=max_steps,
                                cvg_thresh=cfg.root_finding_threshold,
                                active_init=mask)
    trace.count_corr(phase, mask, res.iters if trace.recording() else None)
    return res.x_hat, res.T_fwd, res.valid & mask, res.active, None


def _corr_solve_split(cfg: RayTracerConfig, skin_fn: Callable,
                      frame: CanonicalFrame, skin_dense, x_bar, x0, T0,
                      mask, packed=None, want_jac: bool = False):
    """Straggler-resolve split of the corr solve: phase 1 caps every point
    at `corr_phase1_steps`; the first `corr_resolve_cap` still-active
    points are re-solved from scratch at `corr_max_steps` (a point's
    trajectory does not depend on the others), and only their rows are
    written back, J's too. Returns `_corr_solve`'s five. Actives beyond
    the cap keep their phase-1 result."""
    p1 = cfg.corr_phase1_steps
    if p1 <= 0 or p1 >= cfg.corr_max_steps:
        with trace.span('tracer.corr.p1'):
            return _corr_solve(cfg, skin_fn, frame, skin_dense, x_bar, x0,
                               T0, mask, packed=packed, want_jac=want_jac)
    with trace.span('tracer.corr.p1'):
        x1, T1, v1, act, J1 = _corr_solve(cfg, skin_fn, frame, skin_dense,
                                          x_bar, x0, T0, mask, max_steps=p1,
                                          packed=packed, want_jac=want_jac)
    idx = _resolve_idx(act, cfg.corr_resolve_cap)
    if idx.numel() == 0:
        return x1, T1, v1, torch.zeros_like(act), J1
    with trace.span('tracer.corr.p2'):
        x2, T2, v2, _, J2 = _corr_solve(
            cfg, skin_fn, frame, skin_dense, x_bar[idx], x0[idx], T0[idx],
            torch.ones_like(idx, dtype=torch.bool), packed=packed,
            want_jac=want_jac, phase='p2')
    with trace.span('tracer.corr.write_back'):
        return (_split_write_back(x1, idx, x2),
                _split_write_back(T1, idx, T2),
                _split_write_back(v1, idx, v2), torch.zeros_like(act),
                None if J1 is None else _split_write_back(J1, idx, J2))


def corr_init(cfg: RayTracerConfig, frame: CanonicalFrame, smpl: SmplRef,
              pts_world):
    """Nearest-vertex init of the correspondence search (kernel A under
    `use_pallas_knn`, else `fused_nn_idx`): (x_bar (N, 3) target without
    translation, x0 (N, 3) init, T0 (N, 4, 4) init transform) of world
    points (N, 3)."""
    with trace.span('tracer.corr.init'):
        idx = _knn(cfg, pts_world, smpl.verts_posed).long()
        T0 = torch.einsum('nj,jab->nab', smpl.skinning_weights[idx],
                          frame.bone_transforms)
        x_bar = pts_world - frame.trans
        x0 = apply_transform(inv_affine(T0), x_bar)
        return x_bar.contiguous(), x0.contiguous(), T0


def _warm_start_inits(cfg: RayTracerConfig, z_vals, x_hat_c, T_c, valid_c,
                      x0_f, T0_f):
    """Fine-sample inits from the bracketing coarse roots (port of the JAX
    `_warm_start_inits`). z_vals (n, Sc, C); x_hat_c/T_c/valid_c (n, Sc,
    ...) coarse results; x0_f/T0_f (n, Sc, C-1, ...) nearest-vertex
    fallbacks. Returns (x_init, T_init) of the fine slots 1..C-1: the
    depth-linear interpolation of the two coarse roots where both
    converged and lie within `corr_warm_gate`, the converged side where
    only one did, the fallback otherwise."""
    def shifted(a):      # the next block's coarse value, edge-clamped
        return torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    x_hi, T_hi, valid_hi = shifted(x_hat_c), shifted(T_c), shifted(valid_c)
    z_lo = z_vals[:, :, 0]
    z_hi = shifted(z_lo)
    a = torch.clamp((z_vals[:, :, 1:] - z_lo[..., None])
                    / torch.clamp(z_hi - z_lo, min=1e-8)[..., None],
                    0.0, 1.0)                              # (n, Sc, C-1)
    dist = torch.linalg.norm(x_hi - x_hat_c, dim=-1)
    both = (valid_c & valid_hi & (dist < cfg.corr_warm_gate))[..., None]
    lo_only = (valid_c & ~valid_hi)[..., None]
    hi_only = (valid_hi & ~valid_c)[..., None]

    x_lo_b, x_hi_b = x_hat_c[:, :, None, :], x_hi[:, :, None, :]
    x_interp = (1.0 - a[..., None]) * x_lo_b + a[..., None] * x_hi_b
    x_init = torch.where(
        both[..., None], x_interp,
        torch.where(lo_only[..., None], x_lo_b.expand(x0_f.shape),
                    torch.where(hi_only[..., None], x_hi_b.expand(x0_f.shape),
                                x0_f)))
    T_lo_b = T_c[:, :, None].expand(T0_f.shape)
    T_hi_b = T_hi[:, :, None].expand(T0_f.shape)
    T_near = torch.where((a > 0.5)[..., None, None], T_hi_b, T_lo_b)
    T_init = torch.where(
        both[..., None, None], T_near,
        torch.where(lo_only[..., None, None], T_lo_b,
                    torch.where(hi_only[..., None, None], T_hi_b, T0_f)))
    return x_init, T_init


def canonicalize_samples(cfg: RayTracerConfig, skin_fn: Callable,
                         frame: CanonicalFrame, smpl: SmplRef, cam_loc,
                         ray_dirs, z_vals, sample_mask, skin_dense=None,
                         packed=None, want_jac: bool = False):
    """Backward-map all ray samples to canonical space: nearest-vertex
    init (`corr_init`) then the Broyden correspondence search (kernel B,
    `packed` the trace's `corr_pack`); masked samples are frozen and
    report converge=False. Returns (points_norm (n, S, 3), T_fwd (n, S,
    4, 4), converged (n, S), jac): jac (n, S, 3, 3) from kernel B under
    `want_jac`, else None. With
    `corr_coarse_stride` = C > 1 (and S a multiple of C above C) the
    search runs coarse to fine: slot 0 of every block of C samples solves
    from the nearest-vertex init, the other C-1 from
    `_warm_start_inits`."""
    n, S = z_vals.shape
    pts_world = (cam_loc[:, None, :] + z_vals[..., None]
                 * ray_dirs[:, None, :]).reshape(-1, 3).contiguous()
    flat_mask = sample_mask.reshape(-1).contiguous()
    x_bar, x0, T0 = corr_init(cfg, frame, smpl, pts_world)
    C = cfg.corr_coarse_stride
    if C > 1 and S % C == 0 and S > C:
        Sc = S // C

        def blk(a):
            return a.reshape((n, Sc, C) + a.shape[1:])

        def flat(a):
            return a.reshape((-1,) + a.shape[3:]).contiguous()
        xb_b, x0_b, T0_b, m_b = blk(x_bar), blk(x0), blk(T0), blk(flat_mask)
        xc, Tc, vc, _, Jc = _corr_solve_split(
            cfg, skin_fn, frame, skin_dense, flat(xb_b[:, :, :1]),
            flat(x0_b[:, :, :1]), flat(T0_b[:, :, :1]), flat(m_b[:, :, :1]),
            packed, want_jac)
        xc, Tc, vc = xc.reshape(n, Sc, 3), Tc.reshape(n, Sc, 4, 4), \
            vc.reshape(n, Sc)
        x_init, T_init = _warm_start_inits(
            cfg, z_vals.reshape(n, Sc, C), xc, Tc, vc, x0_b[:, :, 1:],
            T0_b[:, :, 1:])
        xf, Tf, vf, _, Jf = _corr_solve_split(
            cfg, skin_fn, frame, skin_dense, flat(xb_b[:, :, 1:]),
            flat(x_init), flat(T_init), flat(m_b[:, :, 1:]), packed,
            want_jac)
        x_hat = torch.cat([xc[:, :, None], xf.reshape(n, Sc, C - 1, 3)],
                          dim=2).reshape(-1, 3)
        T_fwd = torch.cat([Tc[:, :, None], Tf.reshape(n, Sc, C - 1, 4, 4)],
                          dim=2).reshape(-1, 4, 4)
        valid = torch.cat([vc[:, :, None], vf.reshape(n, Sc, C - 1)],
                          dim=2).reshape(-1)
        jac = None if Jc is None else torch.cat(
            [Jc.reshape(n, Sc, 1, 3, 3), Jf.reshape(n, Sc, C - 1, 3, 3)],
            dim=2)
    else:
        x_hat, T_fwd, valid, _, jac = _corr_solve_split(
            cfg, skin_fn, frame, skin_dense, x_bar, x0, T0, flat_mask,
            packed, want_jac)
    x_norm = normalize_canonical_points(
        x_hat, frame.coord_min, frame.coord_max, frame.center)
    return (x_norm.reshape(n, S, 3), T_fwd.reshape(n, S, 4, 4),
            (valid & flat_mask).reshape(n, S),
            None if jac is None else jac.reshape(n, S, 3, 3))


class TraceOutput(NamedTuple):
    surface: SphereTraceResult
    samples: SamplerResult


def trace_and_sample(cfg: RayTracerConfig, sdf_fn: Callable,
                     skin_fn: Callable, frame: CanonicalFrame, smpl: SmplRef,
                     cam_loc, ray_dirs, near, far, eval_mode: bool = True,
                     skin_dense=None, sdf_gen=None, jitter=None,
                     want_jac: bool = False) -> TraceOutput:
    """Sphere trace + sample + canonicalize (no gradients). Training
    (`eval_mode=False`) keeps every ray valid at the iso refinement and
    jitters the samples with `jitter` (see `sample_z_vals`). Kernels E, F
    and B share one parameter pack (`trace_pack`), built once here; B
    reads its own (`corr_pack`) at a `pallas_precision` other than f32.
    `want_jac`: the samples carry kernel B's Jacobians (`jac`)."""
    with trace.span('tracer.trace'):
        with trace.span('tracer.pack'):
            packed = trace_pack(cfg, sdf_gen, skin_dense)
            cpack = corr_pack(cfg, skin_dense, packed)
        surf = sphere_trace(cfg, sdf_fn, skin_fn, frame, smpl, cam_loc,
                            ray_dirs, near, far, eval_mode=eval_mode,
                            sdf_gen=sdf_gen, skin_dense=skin_dense,
                            packed=packed)
        with trace.span('tracer.sample'):
            z_vals, sample_mask = sample_z_vals(
                cfg, ~surf.unconverged, surf.start_dis, near, far,
                eval_mode, jitter)
        out = canonicalize_samples(
            cfg, skin_fn, frame, smpl, cam_loc, ray_dirs, z_vals,
            sample_mask, skin_dense=skin_dense, packed=cpack,
            want_jac=want_jac)
        return TraceOutput(surf, SamplerResult(z_vals, sample_mask, *out))
