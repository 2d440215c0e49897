"""The flagship eval scene of the port.

`flagship_config()` is the ZJU-MoCap full-size configuration of the JAX
package, field for field (`__graft_entry__._flagship_config`: 256x5 FiLM
hypernet SIREN, 128x4 skinning net, 256x5 colour net with a skip at layer
3, bf16_shading, straggler splits at 16 iterations with resolve caps of
4,096 corr points and 1,024 march and iso rays, and every kernel on:
A-D, the fused march E and the iso refinement F).

`build_scene` makes the bench scene of `__graft_entry__._build_scene` from
the port's own synthetic body, initialiser and frame preparation: a
6,890-vertex body (6,946 vertices of capsules), a camera 2.5 m in front,
half the rays aimed at body vertices and half at uniform points of the
posed box. With `pretrain=True` (the default, the scene the JAX benches
measured) the SIREN and the skinning net are fitted to the capsule body
(`utils/bench_scene.py:pretrain_scene`, 800 Adam steps). With
`pretrain=False` the random-init SIREN is lowered by `SURFACE_SHIFT`
instead, so that rays still find a surface (see there) in the CPU tests,
which cannot afford the fit.
"""
from __future__ import annotations

import numpy as np
import torch

from arah_tpu_torch.core.rays import ray_aabb
from arah_tpu_torch.data.synthetic import synthetic_smpl
from arah_tpu_torch.model import init_model_params, prepare_frame
from arah_tpu_torch.nn.color import ColorConfig, feature_width
from arah_tpu_torch.nn.hypernet import HypernetConfig, siren_layer_dims
from arah_tpu_torch.nn.skinning import SkinningConfig
from arah_tpu_torch.render.ray_tracing import RayTracerConfig
from arah_tpu_torch.render.renderer import ModelConfig, RenderInputs
from arah_tpu_torch.utils.bench_scene import pretrain_scene

N_VERTS = 6890
# The random-init SIREN is positive at every sample of this scene (the JAX
# package's scene too): no ray finds a surface, every frame renders black,
# and the surface paths go untested. Lowering the SIREN's output bias by
# this many metres of canonical distance puts a level set through the
# body's box; about a third of the rays then converge on a surface.
SURFACE_SHIFT = 0.07


def flagship_config() -> ModelConfig:
    return ModelConfig(
        hypernet=HypernetConfig(hidden_features=256, num_hidden_layers=5,
                                hyper_in_ch=144, use_film=True),
        skinning=SkinningConfig(d_hidden=128, n_layers=4),
        color=ColorConfig(d_feature=feature_width('latent'), d_hidden=256,
                          n_layers=5, skips=(3,), multires_view=4,
                          pose_encoder='latent'),
        tracer=RayTracerConfig(corr_phase1_steps=16,
                               march_phase1_steps=16,
                               march_resolve_cap=1024,
                               iso_phase1_steps=16,
                               iso_resolve_cap=1024),
        cano_view_dirs=False, train_skinning_net=True,
        bf16_shading=True)


def _device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('build_scene: no CUDA device; pass '
                               "device='cpu' to build on the CPU")
        return torch.device('cuda')
    return torch.device(device)


def scene_frame(model, rng: np.random.RandomState, device):
    """One frame's SMPL state with a random pose and shape from rng:
    (FrameData, betas (10,))."""
    betas = (rng.randn(10) * 0.3).astype(np.float32)
    pose = (rng.randn(72) * 0.2).astype(np.float32)
    return prepare_frame(model, betas, pose,
                         np.asarray([0.1, 0.0, 0.2], np.float32),
                         device=device), betas


def scene_inputs(params, fd, n_rays: int, rng: np.random.RandomState,
                 device) -> RenderInputs:
    """Camera rays of the bench ray mix for frame `fd`."""
    cam = torch.tensor([0.0, 0.3, -2.5], device=device)
    verts = fd.smpl.verts_posed
    tgt_v = verts[torch.as_tensor(
        rng.randint(0, verts.shape[0], n_rays - n_rays // 2),
        device=device).long()]
    tgt_b = torch.as_tensor(rng.uniform(size=(n_rays // 2, 3)).astype(
        np.float32), device=device) * (fd.bounds_max - fd.bounds_min) \
        + fd.bounds_min
    dirs = torch.cat([tgt_v, tgt_b], dim=0) - cam
    dirs = (dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)).contiguous()
    near, far, _ = ray_aabb(fd.bounds_min, fd.bounds_max,
                            cam.expand(dirs.shape), dirs)
    latent = params['latent'][0]
    return RenderInputs(
        cam_loc=cam, ray_dirs=dirs, near=near, far=far, frame=fd.frame,
        smpl=fd.smpl, rots=fd.rots, Jtrs=fd.Jtrs, rots_full=fd.rots_full,
        Jtrs_posed=fd.Jtrs_posed,
        pose_cond_extra={'latent_code': latent[None]}, geo_latent=latent)


def lower_sdf(params, cfg: ModelConfig, frame, metres: float):
    """Lower the generated SIREN's output by `metres` of canonical
    distance (in place): the output bias is the tail of the last
    `hypo_init` vector, in `frame`'s normalised SDF units."""
    d_in, d_out = siren_layer_dims(cfg.hypernet)[-1]
    with torch.no_grad():
        bias = params['hypernet']['hypo_init'][-1][d_in * d_out:]
        bias -= metres * 2.0 / (1.1 * (frame.coord_max - frame.coord_min))


def build_scene(cfg: ModelConfig, n_rays: int, seed: int = 0, device=None,
                pretrain: bool = True):
    """(params, frame data, render inputs) of the flagship bench scene:
    SIREN and skinning net fitted to the capsule body (`pretrain`), or the
    random-init SIREN lowered by `SURFACE_SHIFT`. Runs on CUDA unless
    `device` says otherwise; with no device and no CUDA it raises."""
    device = _device(device)
    rng = np.random.RandomState(seed)
    params = init_model_params(torch.Generator().manual_seed(seed), cfg,
                               n_latent_frames=4, device=device)
    model = synthetic_smpl(n_verts=N_VERTS)
    fd, betas = scene_frame(model, rng, device)
    if pretrain:
        params, _ = pretrain_scene(params, cfg, model,
                                   torch.as_tensor(betas, device=device), fd)
    else:
        lower_sdf(params, cfg, fd.frame, SURFACE_SHIFT)
    return params, fd, scene_inputs(params, fd, n_rays, rng, device)
