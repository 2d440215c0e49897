"""The flagship scene and train step of the port.

`flagship_config()` is the ZJU-MoCap full-size configuration of the JAX
package, field for field (`__graft_entry__._flagship_config`: 256x5 FiLM
hypernet SIREN, 128x4 skinning net, 256x5 colour net with a skip at layer
3, bf16_shading, straggler splits at 16 iterations with resolve caps of
4,096 corr points and 1,024 march and iso rays, and every kernel on:
A-D, the fused march E, the iso refinement F and, in training, G-I).

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

`build_train_setup` makes the flagship train step that the JAX package's
`bench.py` times: the fitted scene, one block of 8,192 rays with 1,024
regulariser points, `LossWeights(n_ray_loss=n_rays)` and
`OptimConfig(train_skinning_net=True)`. With `refined=True` it makes the
step as the H36M configs train it (`train_smpl: true`): SMPL and camera
refinement, `REFINED_BLOCKS` blocks, each on its own pose of the bench
body, and a `PATCH` x `PATCH` patch of rays for the perceptual loss
after each block's loss rays.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from arah_tpu_torch.config.factory import smpl_refine_params
from arah_tpu_torch.core.rays import ray_aabb
from arah_tpu_torch.core.smpl import smpl_to_device
from arah_tpu_torch.data.batch import synthetic_train_batch
from arah_tpu_torch.data.synthetic import synthetic_smpl
from arah_tpu_torch.model import init_model_params, prepare_frame
from arah_tpu_torch.nn.color import ColorConfig, feature_width
from arah_tpu_torch.nn.hypernet import HypernetConfig, siren_layer_dims
from arah_tpu_torch.nn.skinning import SkinningConfig
from arah_tpu_torch.parallel.train_step import (TrainState, make_train_step,
                                                trainable)
from arah_tpu_torch.render.ray_tracing import RayTracerConfig
from arah_tpu_torch.render.renderer import ModelConfig, RenderInputs
from arah_tpu_torch.train.loss import LossWeights
from arah_tpu_torch.train.optim import OptimConfig, make_optimizer
from arah_tpu_torch.utils.bench_scene import pretrain_scene

N_VERTS = 6890
# The random-init SIREN is positive at every sample of this scene (the JAX
# package's scene too): no ray finds a surface, every frame renders black,
# and the surface paths go untested. Lowering the SIREN's output bias by
# this many metres of canonical distance puts a level set through the
# body's box; about a third of the rays then converge on a surface.
SURFACE_SHIFT = 0.07
SCENE_TRANS = np.asarray([0.1, 0.0, 0.2], np.float32)
REFINED_BLOCKS = 2      # ray blocks of the refined step, a pose each
PATCH = 48              # the refined step's patch side (LossWeights')


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


def scene_pose(rng: np.random.RandomState):
    """A random shape and pose from rng: (betas (10,), pose (72,))."""
    betas = (rng.randn(10) * 0.3).astype(np.float32)
    pose = (rng.randn(72) * 0.2).astype(np.float32)
    return betas, pose


def scene_frame(model, rng: np.random.RandomState, device):
    """One frame's SMPL state with a random pose and shape from rng:
    (FrameData, betas (10,)), without an autograd graph."""
    betas, pose = scene_pose(rng)
    with torch.no_grad():
        return prepare_frame(model, betas, pose, SCENE_TRANS,
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


class TrainSetup(NamedTuple):
    params: Any           # the parameter tree (leaves require grad)
    optimizer: Any        # train.optim.Optimizer over params
    state: Any            # parallel.train_step.TrainState
    batch: Any            # parallel.train_step.TrainBatch
    loss_w: Any           # train.loss.LossWeights
    step: Any             # step(state, batch, draws) -> (state, losses)
    step_options: dict    # make_train_step's keywords (SMPL model, options)


def _patch_rays(fwd, g):
    """Unit rays of a pinhole grid: offsets g (radians) along the image's
    up and right axes around the direction `fwd`."""
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(
        fwd, torch.tensor([0.0, 1.0, 0.0], device=fwd.device))
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, fwd)
    d = (fwd + g[:, None, None] * up + g[None, :, None] * right) \
        .reshape(-1, 3)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def append_patch(batch, rng: np.random.RandomState, ps: int, fds,
                 aims=None):
    """`batch` with one ps x ps grid of rays a block appended after its
    rays, as the dataset appends its perceptual-loss patch around a
    random foreground pixel (`data/human_video.py`): a pinhole grid 0.1
    rad wide (25 cm at the bench camera's 2.5 m; 2.1 mrad a pixel at ps =
    48) around the ray to a random posed vertex of the block's frame
    (`fds[b]`), its near and far from the frame's box whether or not a
    ray meets it (the sampler masks the samples of a ray that misses:
    `render/ray_tracing.py:sample_z_vals`), uniform rgb targets and mask
    labels from each ray's distance to the body's vertices: 1
    (foreground) within 3 cm, 100 (boundary, which the RGB loss skips)
    within 6 cm, else 0 (background, its target black). `aims` (B, 3):
    the points the patches centre on instead."""
    dev = batch.ray_dirs.device
    g = (torch.arange(ps, dtype=torch.float32, device=dev)
         - (ps - 1) / 2.0) * (0.1 / ps)
    cols = {k: [] for k in ('ray_dirs', 'near', 'far', 'rgb_gt',
                            'body_mask')}
    for b, fd in enumerate(fds):
        verts = fd.smpl.verts_posed
        o = batch.cam_loc[b]
        aim = verts[int(rng.randint(verts.shape[0]))] if aims is None \
            else aims[b]
        d = _patch_rays(aim - o, g)
        near, far, _ = ray_aabb(fd.bounds_min, fd.bounds_max,
                                o.expand(d.shape), d)
        rel = verts - o
        along = d @ rel.T
        dist = torch.sqrt(torch.clamp(
            (rel * rel).sum(-1)[None] - along * along, min=0.0)).amin(-1)
        label = torch.where(dist < 0.03, 1, torch.where(dist < 0.06, 100, 0))
        rgb = torch.as_tensor(rng.uniform(size=(ps * ps, 3)).astype(
            np.float32), device=dev) * (label != 0)[:, None]
        for k, v in (('ray_dirs', d), ('near', near), ('far', far),
                     ('rgb_gt', rgb), ('body_mask', label.int())):
            cols[k].append(v)
    cat = {k: torch.cat([getattr(batch, k), torch.stack(v)], dim=1)
           .contiguous() for k, v in cols.items()}
    return batch._replace(**cat, uv=cat['ray_dirs'])


def build_train_setup(cfg: ModelConfig, n_rays: int = 8192,
                      n_reg: int = 1024, pretrain: bool = True,
                      seed: int = 0, device=None, scene=None,
                      refined: bool = False) -> TrainSetup:
    """The flagship train step of the JAX bench (`bench.py:99-108`) on
    the bench scene: one block of `n_rays` rays and `n_reg` regulariser
    points from seed 1, on the card unless `device` says otherwise.
    `scene` = (params, frame data) of an earlier `build_scene` call with
    the same seed skips the fit; its params are copied, not trained.

    `refined`: the step as the H36M configs train it. `REFINED_BLOCKS`
    blocks, block b on its own pose of the bench body (block 0 on the
    scene's, the others drawn from seed 100 + seed with the scene's
    betas; latent row b); one `PATCH` x `PATCH` patch of rays a block
    after its loss rays (`append_patch`), its perceptual loss weighted 1;
    SMPL and camera refinement. The SMPL leaves hold the frames' poses,
    the scene's betas and translation (all-zero axis-angles moved by
    1e-8, as from a dataset); the camera of block b is an identity
    quaternion with `cam_trans = -cam_loc`, and `uv = ray_dirs`, so that
    the refined frames and rays start as the batch's own."""
    if scene is None:
        params, fd, _ = build_scene(cfg, 16, seed=seed, device=device,
                                    pretrain=pretrain)
    else:
        params, fd = scene
    dev = fd.verts_cano.device
    model = smpl_to_device(synthetic_smpl(n_verts=N_VERTS), dev)
    betas, pose = scene_pose(np.random.RandomState(seed))
    n_blocks, fds, opts = 1, None, {}
    rng = np.random.RandomState(1)
    if refined:
        n_blocks = REFINED_BLOCKS
        prng = np.random.RandomState(100 + seed)
        poses = [pose] + [scene_pose(prng)[1] for _ in range(n_blocks - 1)]
        with torch.no_grad():
            fds = [fd] + [prepare_frame(model, betas, p, SCENE_TRANS,
                                        device=dev) for p in poses[1:]]
    batch = synthetic_train_batch(rng, fd, n_blocks=n_blocks, n_rays=n_rays,
                                  n_reg=n_reg, fds=fds)
    params = dict(params)
    loss_w = LossWeights(n_ray_loss=n_rays)
    if refined:
        batch = append_patch(batch, rng, PATCH, fds)
        p = np.stack(poses)
        params.update(smpl_refine_params(
            p[:, :3], p[:, 3:66], p[:, 66:],
            np.tile(SCENE_TRANS, (n_blocks, 1)), betas, device=dev))
        params['cam_rots'] = torch.tensor([[0.0, 0.0, 0.0, 1.0]] * n_blocks,
                                          device=dev)
        params['cam_trans'] = -batch.cam_loc
        loss_w = loss_w._replace(perceptual=1.0, patch_size=PATCH)
        opts = dict(smpl_model=model, refine_smpl=True, refine_cameras=True,
                    per_block_frame=True)
    params = trainable(params)
    optimizer, _ = make_optimizer(OptimConfig(train_skinning_net=True),
                                  params)
    return TrainSetup(params, optimizer, TrainState(params, optimizer, 0),
                      batch, loss_w,
                      make_train_step(cfg, loss_w, optimizer, **opts), opts)
