"""The ARAH volume renderer's eval forward pass: hypernetwork SDF,
skinning network, ray tracer, colour network and VolSDF compositing.
Port of `arah_tpu/render/renderer.py` (`render(training=False)`).

Kernels on this path: the shading kernel C (SDF, features and normals of
every sample) and the colour kernel D, plus A, B, E and F inside the
tracer, which gets the generated SIREN (for E and F) and the collapsed
skinning MLP (for B and F) as the JAX renderer hands them over.
Training (`training=True`) is a later slice of the port and raises.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from arah_tpu_torch.core.body import sdf_to_metric
from arah_tpu_torch.core.linalg import inv_affine
from arah_tpu_torch.nn.color import (ColorConfig, color_apply,
                                     color_pose_feature)
from arah_tpu_torch.nn.deviation import deviation_value
from arah_tpu_torch.nn.hypernet import (HypernetConfig, hypernet_cond,
                                        hypernet_flat_params,
                                        hypernet_generate)
from arah_tpu_torch.nn.siren import GeneratedMLP, siren_apply
from arah_tpu_torch.nn.skinning import (SkinningConfig,
                                        skinning_dense_params,
                                        skinning_weights)
from arah_tpu_torch.ops.shade import siren_shade
from arah_tpu_torch.render.ray_tracing import (CanonicalFrame,
                                               RayTracerConfig, SmplRef,
                                               trace_and_sample)
from arah_tpu_torch.render.volsdf import composite_masked, volsdf_density


class ModelConfig(NamedTuple):
    """Field for field the JAX `ModelConfig`, with its defaults. The
    training-path fields (`use_pallas_shade_grad`, the idiff options,
    `n_eik_points`, `train_skinning_net`) are carried for that later
    slice; `pallas_*_tile` sized the TPU kernels and are not read."""
    hypernet: HypernetConfig = HypernetConfig()
    skinning: SkinningConfig = SkinningConfig()
    color: ColorConfig = ColorConfig()
    tracer: RayTracerConfig = RayTracerConfig()
    cano_view_dirs: bool = True
    train_skinning_net: bool = False
    render_last_pt: bool = False
    n_eik_points: int = 1024
    # bf16 operands / f32 accumulation in the shading stage (SIREN
    # features+normals and the colour MLP); solvers stay f32
    bf16_shading: bool = False
    # True: SDF, features and normals from the shading kernel C (CUDA on a
    # CUDA tensor, its plain version on a CPU tensor). False: siren_apply
    # plus one autograd reverse pass for the normals.
    use_pallas_shade: bool = True
    pallas_shade_tile: int = 512
    use_pallas_shade_grad: bool = True
    pallas_shade_grad_tile: int = 256
    shade_resid_bf16: bool = False
    shade_pack: bool = False
    shade_pack_frac: float = 0.95
    shade_pack_align: int = 512
    idiff_linearize: bool = True
    idiff_kernel_jac: bool = False
    idiff_standalone_jac: bool = True


def make_skin_fn(params, cfg: ModelConfig):
    """Normalized canonical points (N, 3) -> (N, 24) skinning weights."""
    return lambda x: skinning_weights(params['skinning'], cfg.skinning, x)


def make_sdf_fn(gen: GeneratedMLP):
    """Normalized canonical points (N, 3) -> (N,) normalized SDF."""
    return lambda x: siren_apply(gen, x)[..., 0]


def generate_sdf(params, cfg: ModelConfig, rots, Jtrs, geo_latent=None):
    """Per-frame hypernetwork pass -> generated SIREN weights.
    rots: (1, 24, 9); Jtrs: (1, 24, 3)."""
    if 'sdf_plain' in params:
        raise NotImplementedError('the single_bvp SDF variant is not ported')
    cond = hypernet_cond(params['hypernet'], cfg.hypernet, rots, Jtrs)[0]
    latent = None
    if cfg.hypernet.use_film and geo_latent is not None:
        latent = geo_latent
    elif geo_latent is not None:
        cond = cond + geo_latent
    return hypernet_generate(params['hypernet'], cfg.hypernet, cond, latent)


class RenderInputs(NamedTuple):
    """Per-step inputs for one frame (the eval fields of the JAX
    `RenderInputs`)."""
    cam_loc: torch.Tensor          # (3,)
    ray_dirs: torch.Tensor         # (N, 3)
    near: torch.Tensor             # (N,)
    far: torch.Tensor              # (N,)
    frame: CanonicalFrame
    smpl: SmplRef
    rots: torch.Tensor             # (1, 24, 9) local rots (root = I)
    Jtrs: torch.Tensor             # (1, 24, 3) normalized rest joints
    rots_full: torch.Tensor        # (1, 24, 9) incl. root
    Jtrs_posed: torch.Tensor       # (1, 24, 3)
    pose_cond_extra: dict          # latent_code/... (may be {})
    geo_latent: Any = None         # (128,) or None


def _shade_sdf(cfg: ModelConfig, gen: GeneratedMLP, flat_p):
    """(sdf (N,), features, normals (N, 3)) of the generated SIREN."""
    if cfg.use_pallas_shade:
        out, feats, grads = siren_shade(gen, flat_p, bf16=cfg.bf16_shading,
                                        resid_bf16=cfg.shade_resid_bf16)
        return out[:, 0], feats, grads
    with torch.enable_grad():
        p = flat_p.detach().requires_grad_(True)
        out, feats = siren_apply(gen, p, return_features=True,
                                 bf16=cfg.bf16_shading)
        grads, = torch.autograd.grad(out[:, 0].sum(), p)
    return out[:, 0].detach(), feats.detach(), grads


def shade_samples(params, cfg: ModelConfig, gen: GeneratedMLP,
                  frame: CanonicalFrame, points_norm, z_vals,
                  transforms_fwd, converge_mask, view_dirs, pose_feature):
    """SDF + colour + VolSDF compositing over dense (n_rays, S) samples
    (eval). Returns (rgb (n_rays, 3), weights_sum (n_rays,))."""
    if cfg.shade_pack:
        raise NotImplementedError('shade_pack (a TPU A/B) is not ported')
    n_rays, S, _ = points_norm.shape
    flat_p = points_norm.reshape(-1, 3).contiguous()
    flat_T = transforms_fwd.reshape(-1, 4, 4)
    vd = view_dirs[:, None, :].expand(n_rays, S, 3).reshape(-1, 3)
    if cfg.cano_view_dirs:
        in_vd = torch.einsum('nab,nb->na', inv_affine(flat_T)[:, :3, :3],
                             -vd)
    else:
        in_vd = -vd

    sdf_norm, feats, normal = _shade_sdf(cfg, gen, flat_p)
    if not cfg.cano_view_dirs:
        normal = torch.einsum('nab,nb->na', flat_T[:, :3, :3], normal)
    rgb = color_apply(params['color'], cfg.color, flat_p, normal, in_vd,
                      feats, pose_feature, bf16=cfg.bf16_shading)
    density = volsdf_density(
        sdf_to_metric(sdf_norm, frame.coord_min, frame.coord_max),
        deviation_value(params['deviation']))
    out = composite_masked(rgb.reshape(n_rays, S, 3),
                           density.reshape(n_rays, S), z_vals,
                           converge_mask, cfg.tracer.n_steps,
                           render_last_pt=cfg.render_last_pt)
    return out.rgb, out.weights_sum


@torch.no_grad()
def render(params, cfg: ModelConfig, inp: RenderInputs, key=None,
           training: bool = False):
    """Eval render of one frame's ray block; returns the eval keys of the
    JAX `render` output dict. `key` is unused (eval draws no noise)."""
    if training:
        raise NotImplementedError('render(training=True) is a later slice '
                                  'of the port')
    gen = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    skin_dense = None
    if cfg.tracer.use_pallas_corr or cfg.tracer.use_pallas_iso:
        sd = skinning_dense_params(params['skinning'], cfg.skinning)
        if sd is not None:
            skin_dense = (sd[0], sd[1], cfg.skinning.softmax_scale)
    sdf_gen = gen if (cfg.tracer.use_pallas_march
                      or cfg.tracer.use_pallas_iso) else None
    trace = trace_and_sample(
        cfg.tracer, make_sdf_fn(gen), make_skin_fn(params, cfg), inp.frame,
        inp.smpl, inp.cam_loc.expand(inp.ray_dirs.shape), inp.ray_dirs,
        inp.near, inp.far, eval_mode=True, skin_dense=skin_dense,
        sdf_gen=sdf_gen)
    samples = trace.samples

    pose_cond = dict(inp.pose_cond_extra)
    pose_cond.update({'rots_full': inp.rots_full,
                      'Jtrs_posed': inp.Jtrs_posed})
    pose_feature = color_pose_feature(params['color'], cfg.color, pose_cond)
    rgb_values, weights_sum = shade_samples(
        params, cfg, gen, inp.frame, samples.points_norm, samples.z_vals,
        samples.transforms, samples.converge_mask, inp.ray_dirs,
        pose_feature)
    n_dense = samples.converge_mask.numel()
    return {
        'rgb_values': rgb_values,
        'weights_sum': weights_sum,
        'network_body_mask': samples.converge_mask.any(dim=-1),
        'n_samples_valid': samples.converge_mask.sum(),
        'n_samples_dense': n_dense,
        'n_samples_shaded': n_dense,
        'n_samples_overflow': 0,
        'surface_depth': trace.surface.start_dis,
        'surface_converged': ~trace.surface.unconverged,
        'surface_points_norm': trace.surface.points_norm,
        'sdf_params': hypernet_flat_params(gen),
        'deviation': deviation_value(params['deviation']),
    }
