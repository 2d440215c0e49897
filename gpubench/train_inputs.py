"""The inputs of the train cells, made by the benchmark with the
reference's modules, the same for the program and the plain reference.

The subject is `inputs.build_scene`'s: the capsule body, one pose a
training frame and the fitted weights, one set for every seed. On it:

- The pool: `pool` step batches, the same for every seed, each of
  `blocks` ray blocks. A block is a (frame, view) pair of the
  configuration's training frames and `train_views`, drawn once from
  the subject's seed (with a frame each where the configuration batches
  several frames, else one frame for the step's blocks), and holds what
  a dataset item holds (`data/human_video.py`): `fg_rays` rays through
  foreground pixels and `bg_rays` through the box's background pixels,
  their colours (a uniform body colour, black background) and mask
  labels (1, 0), and 1,024 each of the off-surface, surface-skinning
  and inside points with the surface points' skinning weights. The
  mask is the posed capsule body's: a pixel whose ray passes within the
  capsule radius of a posed bone. The pose and view input noise, drawn
  as the trainer's collate draws it (half the steps none), is part of
  the pool.
- The draws of a step (sample jitter, eikonal points) come from the
  run's seed and the step's index (`step_draws`).
- The learnable SMPL leaves, where the configuration refines SMPL: the
  frames' poses, translations and shape, perturbed from a fixed seed as
  a noisy fit would be (`smpl_leaves`).
"""
from __future__ import annotations

import math
import numpy as np
import torch

from gpubench import inputs
from gpubench.reference.body import (normalize_canonical_points,
                                     unnormalize_canonical_points)
from gpubench.reference.fit import (capsule_sdf_and_weights,
                                    capsule_segments_02v)
from gpubench.reference.ray_tracing import jitter_shapes
from gpubench.reference.smpl import SMPL_PARENTS
from gpubench.reference.train import Block

BODY_RGB = (0.62, 0.48, 0.40)
CAPSULE_RADIUS = 0.055
N_REG = 1024
# eikonal points a block: the trainer's (`ModelConfig.n_eik_points`),
# which no configuration sets
N_EIK = 1024
# noise of the SMPL leaves' initial fit: axis-angle (rad), metres, shape
FIT_NOISE = {'pose': 0.02, 'trans': 0.01, 'betas': 0.02}


def _rng(*salt) -> np.random.RandomState:
    return np.random.RandomState([inputs.SUBJECT_SEED, *salt])


def fg_mask(fd, cam_loc, dirs, radius: float = CAPSULE_RADIUS):
    """(P,) bool: rays (from cam_loc, unit dirs (P, 3)) that pass within
    `radius` of a posed bone (the segments between the frame's posed
    joints and their parents)."""
    J = fd.Jtrs_posed[0]
    has_parent = torch.as_tensor(SMPL_PARENTS >= 0, device=J.device)
    a = J[np.maximum(SMPL_PARENTS, 0)][has_parent]
    b = J[has_parent]
    o = torch.as_tensor(cam_loc, device=dirs.device)
    # closest points of each ray (o + s d, s >= 0) and segment (a + t u)
    u = b - a
    w0 = o[None, None] - a[None]                       # (1, S, 3)
    d = dirs[:, None, :]                               # (P, 1, 3)
    uu = (u * u).sum(-1)[None]
    du = (d * u[None]).sum(-1)
    dw = (d * w0).sum(-1)
    uw = (u[None] * w0).sum(-1)
    den = torch.clamp(uu - du * du, min=1e-12)
    # the segment parameter of the lines' closest points, clamped to the
    # segment; then the ray's nearest point to it, clamped to s >= 0
    t = torch.clamp((uw - du * dw) / den, 0.0, 1.0)
    s = torch.clamp(du * t - dw, min=0.0)
    gap = w0 + s[..., None] * d - t[..., None] * u[None]
    return torch.linalg.norm(gap, dim=-1).min(-1)[0] < radius


def _reg_points(fd, seg, rng, device):
    """(points_uniform, points_skinning, sampled_weights, points_inside)
    of a frame's canonical body, N_REG each (`_sample_reg_points`'s
    rules on the capsule body: off-surface points farther than the
    dataset's `off_surface_thr` of 0.2 m^2 squared distance, surface
    points on the canonical vertices with their weights, inside points
    deeper than `inside_thr`'s 0.001 m^2, hands left out)."""
    frame = fd.frame
    cmin, cmax, center = frame.coord_min, frame.coord_max, frame.center

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    cand = t(rng.rand(4096, 3) * 2.0 - 1.0)
    sdf, _ = capsule_sdf_and_weights(
        unnormalize_canonical_points(cand, cmin, cmax, center), *seg)
    far = torch.nonzero(sdf > math.sqrt(0.2))[:, 0].cpu().numpy()
    pick = far if len(far) else np.arange(4096)
    uniform = cand[torch.as_tensor(
        rng.choice(pick, N_REG, replace=len(pick) < N_REG), device=device)]

    vidx = rng.randint(0, fd.verts_cano.shape[0], N_REG)
    skin_pts = fd.verts_cano[torch.as_tensor(vidx, device=device)]
    _, skin_w = capsule_sdf_and_weights(skin_pts, *seg)

    a, b = seg
    bones = rng.choice(np.arange(1, 22), 4 * N_REG)   # no hands (22, 23)
    tt = t(rng.rand(4 * N_REG, 1))
    off = t(rng.randn(4 * N_REG, 3) * 0.012)
    inside = a[bones] + tt * (b[bones] - a[bones]) + off
    depth, _ = capsule_sdf_and_weights(inside, *seg)
    deep = torch.nonzero(depth <= -math.sqrt(0.001))[:, 0].cpu().numpy()
    pick = deep if len(deep) else np.arange(len(bones))
    inside = inside[torch.as_tensor(
        rng.choice(pick, N_REG, replace=len(pick) < N_REG), device=device)]
    inside = normalize_canonical_points(inside, cmin, cmax, center)
    return uniform, skin_pts, skin_w, inside


def _axis_rot(axis: int, deg: float) -> np.ndarray:
    sn, cs = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    r = np.eye(3)
    r[i, i] = r[j, j] = cs
    r[i, j], r[j, i] = (sn, -sn) if axis == 1 else (-sn, sn)
    return r


def step_noise(rng, n_blocks: int, pose: bool, view: bool) -> dict:
    """The trainer's input noise of one step (`sample_noise`'s laws):
    with probability 0.5 none; else N(0, 0.1) on the hypernet's rotations
    and the colour net's root pose, and one clipped-Euler view rotation
    (roll and yaw N(0, 45) deg clipped at 90, pitch U(0, 45) deg) shared
    by the step's blocks."""
    out = {'rots_noise': np.zeros((n_blocks, 24, 9), np.float32),
           'rot_noise': np.zeros((n_blocks, 1, 9), np.float32),
           'trans_noise': np.zeros((n_blocks, 1, 3), np.float32),
           'view_noise': np.broadcast_to(np.eye(3, dtype=np.float32),
                                         (n_blocks, 3, 3)).copy()}
    if rng.uniform() > 0.5:
        return out
    if pose:
        out['rots_noise'] = rng.normal(0, 0.1, (n_blocks, 24, 9)) \
            .astype(np.float32)
        out['rot_noise'] = rng.normal(0, 0.1, (n_blocks, 1, 9)) \
            .astype(np.float32)
        out['trans_noise'] = rng.normal(0, 0.1, (n_blocks, 1, 3)) \
            .astype(np.float32)
    if view:
        rx = float(np.clip(rng.randn() * 45, -90, 90))
        ry = float(np.clip(rng.rand() * 45, -90, 90))
        rz = float(np.clip(rng.randn() * 45, -90, 90))
        R = (_axis_rot(0, rx) @ _axis_rot(1, ry) @ _axis_rot(2, rz))
        out['view_noise'] = np.broadcast_to(
            R.astype(np.float32), (n_blocks, 3, 3)).copy()
    return out


def make_pool(scene, cfg: dict, tr: dict, device) -> list:
    """The cell's `pool` step batches, one set for every seed: each a
    list of its blocks (`reference/train.py:Block`, without their draws,
    which are None)."""
    data, training = cfg['data'], cfg['training']
    cams = inputs.ring_cameras(cfg['scene'])
    n_frames = data['train_end_frame'] - data['train_start_frame']
    views = list(data['train_views'])
    n_blocks = tr['blocks']
    per_block = bool(training.get('multi_frame_batch', False))
    seg = capsule_segments_02v(
        scene.model, torch.as_tensor(scene.betas, device=device))
    rng = _rng(17)
    pool = []
    for k in range(tr['pool']):
        frames = (rng.randint(0, n_frames, n_blocks) if per_block
                  else np.full(n_blocks, rng.randint(0, n_frames)))
        noise = step_noise(rng, n_blocks,
                           bool(training.get('pose_input_noise', False)),
                           bool(training.get('view_input_noise', False)))
        blocks = []
        for b, f in enumerate(frames):
            f = int(f)
            fd = scene.frames[f]
            cam = cams[views[rng.randint(len(views))]]
            _, _, dirs, near, far = inputs.box_pixels(cam, fd, device)
            fg = fg_mask(fd, cam.loc, dirs)
            fg_i = torch.nonzero(fg)[:, 0].cpu().numpy()
            bg_i = torch.nonzero(~fg)[:, 0].cpu().numpy()
            pick = np.concatenate([
                rng.choice(fg_i, tr['fg_rays'],
                           replace=len(fg_i) < tr['fg_rays']),
                rng.choice(bg_i, tr['bg_rays'],
                           replace=len(bg_i) < tr['bg_rays'])])
            idx = torch.as_tensor(pick, device=device)
            n_fg = tr['fg_rays']
            mask = torch.zeros(len(pick), dtype=torch.int32, device=device)
            mask[:n_fg] = 1
            rgb = torch.zeros((len(pick), 3), device=device)
            rgb[:n_fg] = torch.tensor(BODY_RGB, device=device)
            uni, skin_p, skin_w, inside = _reg_points(fd, seg, rng, device)

            def nz(key):
                return torch.as_tensor(noise[key][b], device=device)
            blocks.append(Block(
                cam_loc=torch.as_tensor(cam.loc, device=device),
                ray_dirs=dirs[idx].contiguous(), near=near[idx].contiguous(),
                far=far[idx].contiguous(), rgb_gt=rgb, body_mask=mask,
                points_uniform=uni, points_skinning=skin_p,
                points_inside=inside, sampled_weights=skin_w,
                rots_noise=nz('rots_noise'), view_noise=nz('view_noise'),
                rot_noise=nz('rot_noise'), trans_noise=nz('trans_noise'),
                frame_idx=f, u1=None, u2=None, u3=None, points_eik=None))
        pool.append(blocks)
    return pool


def step_draws(seed: int, step: int, n_blocks: int, n_rays: int, ref_cfg,
               device, n_eik: int = N_EIK):
    """(u1, u2, u3, points_eik), each with a leading block dimension: the
    uniform sample jitter and the eikonal points in [-1, 1]^3 of window
    step `step` (warm-up steps are negative), from the run's seed."""
    gen = torch.Generator(device=device).manual_seed(
        inputs.torch_seed(seed, 1000 + step if step >= 0 else -step))
    s1, s2, s3 = jitter_shapes(ref_cfg.tracer, n_rays)
    u = [torch.rand((n_blocks,) + s, generator=gen, device=device)
         for s in (s1, s2, s3)]
    eik = torch.rand((n_blocks, n_eik, 3), generator=gen,
                     device=device) * 2.0 - 1.0
    return u[0], u[1], u[2], eik


def smpl_leaves(scene, device) -> dict:
    """The learnable SMPL leaves: every training frame's pose (root,
    body, hands) and translation and the one shape, perturbed from a
    fixed seed (`FIT_NOISE`), as a noisy fit would be."""
    rng = _rng(23)
    F = scene.poses.shape[0]
    poses = scene.poses + rng.normal(0, FIT_NOISE['pose'], scene.poses.shape)
    trans = scene.trans[None] + rng.normal(0, FIT_NOISE['trans'], (F, 3))
    betas = scene.betas + rng.normal(0, FIT_NOISE['betas'],
                                     scene.betas.shape)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {'smpl_params': {'root_orient': t(poses[:, :3]),
                            'pose_body': t(poses[:, 3:66]),
                            'pose_hand': t(poses[:, 66:72]),
                            'trans': t(trans)},
            'betas': t(betas)}
