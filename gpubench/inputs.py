"""The inputs of every cell, made by the benchmark, and the same for the
program and the plain reference.

- The body: the synthetic SMPL-topology body of the configuration
  (`scene.n_verts` vertices of capsules, `reference/synthetic.py`).
- The weights: the parameter tree drawn on the device (`reference/
  layers.py:Draws`), then the SIREN's `hypo_init` and the skinning net
  fitted to the capsule body (`reference/fit.py`, 800 Adam steps).
- The frames: one SMPL pose per training frame.
- The cameras: `scene.cameras`, a ring of views around the body.
- The rays of an eval item: every box ray of the image.

The subject (body, frames and weights) is one for every seed, as a
trained avatar is: the seed draws the order of the work, never its
amount. The fitted leaves are kept in `.cache/gpubench/` inside the
checkout under a key of everything they depend on (`fit_key`), written
atomically, so that only the first run of a checkout fits.

Everything here is computed with the reference's modules, never with the
program's, so that neither side makes what the other is judged by.
"""
from __future__ import annotations

import glob
import hashlib
import json
import math
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from gpubench.reference.fit import pretrain_scene, with_leaves
from gpubench.reference.hypernet import siren_layer_dims
from gpubench.reference.layers import Draws
from gpubench.reference.model import init_model_params, prepare_frame
from gpubench.reference.renderer import generate_sdf
from gpubench.reference.siren import siren_apply
from gpubench.reference.smpl import smpl_to_device
from gpubench.reference.synthetic import synthetic_smpl

HERE = os.path.dirname(os.path.abspath(__file__))
# the fitted leaves' cache: a fixed directory inside the checkout
FIT_CACHE = os.path.join(os.path.dirname(HERE), '.cache', 'gpubench')
SCENE_TRANS = (0.1, 0.0, 0.2)
SUBJECT_SEED = 20201231    # the synthetic subject's shape, poses, weights

def fixed_set(pairs: list, n: int) -> list:
    """The first n of the pairs in one fixed order (every seed's set)."""
    order = np.random.RandomState(SUBJECT_SEED).permutation(len(pairs))
    return [pairs[i] for i in order[:n]]


def seed_words(seed: int, *salt: int) -> list:
    """A numpy seed sequence from a seed of any size and a salt."""
    return [seed & 0xffffffff, seed >> 32, *salt]


def torch_seed(seed: int, salt: int) -> int:
    return int(np.random.RandomState(seed_words(seed, salt))
               .randint(0, 2 ** 62))


class Camera(NamedTuple):
    K: np.ndarray      # (3, 3)
    R: np.ndarray      # (3, 3) world -> camera
    T: np.ndarray      # (3,)
    loc: np.ndarray    # (3,) camera centre in world
    H: int
    W: int


def ring_cameras(scene: dict) -> dict:
    """name -> Camera: `count` views on a horizontal ring of `radius`
    metres around the body's centre at `height`, view i (1-based) at
    angle 2 pi (i - 1) / count, each looking at the centre, focal
    `focal` px, principal point at the image centre."""
    c = scene['cameras']
    H, W = scene['img_size']
    centre = np.asarray(SCENE_TRANS, np.float64) + [0.0, c['height'], 0.0]
    out = {}
    for name, i in c['views'].items():
        a = 2.0 * math.pi * (i - 1) / c['count']
        loc = centre + c['radius'] * np.array([math.sin(a), 0.0,
                                               math.cos(a)])
        z = centre - loc
        z /= np.linalg.norm(z)
        x = np.cross([0.0, -1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        K = np.array([[c['focal'], 0.0, W / 2.0],
                      [0.0, c['focal'], H / 2.0], [0.0, 0.0, 1.0]])
        out[name] = Camera(K.astype(np.float32), R.astype(np.float32),
                           (-R @ loc).astype(np.float32),
                           loc.astype(np.float32), H, W)
    return out


class Scene(NamedTuple):
    model: Any           # reference SmplModel, numpy arrays
    model_dev: Any       # the same on the device
    params: dict         # the fitted parameter tree (no grad)
    betas: np.ndarray    # (10,)
    poses: np.ndarray    # (F, 72) one pose per training frame
    trans: np.ndarray    # (3,)
    frames: list         # reference FrameData of each training frame
    fit_s: float         # seconds of the fit, or of reading it back
    fit_loss: float      # its last loss
    fit_cached: bool     # read back from the cache


def frame_poses(n_frames: int):
    """(betas (10,), poses (n_frames, 72)): the subject, one body shape
    and a pose a training frame. Fixed, as a dataset's frames are."""
    rng = np.random.RandomState(SUBJECT_SEED)
    betas = (rng.randn(10) * 0.3).astype(np.float32)
    poses = (rng.randn(n_frames, 72) * 0.2).astype(np.float32)
    return betas, poses


def lower_sdf(params, cfg, fd, seed: int):
    """Move the generated SIREN's output (in place) by its median over
    4,096 points of the frame's normalised box, so that its zero level
    set runs through the box: the output bias is the tail of the last
    `hypo_init` vector."""
    d_in, d_out = siren_layer_dims(cfg.hypernet)[-1]
    dev = fd.verts_cano.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((4096, 3), generator=gen, device=dev) * 2.0 - 1.0
    with torch.no_grad():
        sdf = generate_sdf(params, cfg, fd.rots, fd.Jtrs,
                           params['latent'][0])
        bias = params['hypernet']['hypo_init'][-1][d_in * d_out:]
        bias -= torch.median(siren_apply(sdf, x)[:, 0])


def fit_key(cfg: dict, fit_steps: int, device) -> str:
    """A digest of everything the fitted leaves depend on: the
    configuration, the fit's length and seeds, the code that draws and
    fits them (this module and `reference/`), torch's version and the
    device."""
    h = hashlib.sha256(json.dumps(
        [cfg, fit_steps, SUBJECT_SEED, torch.__version__, str(device),
         torch.cuda.get_device_name(device) if device.type == 'cuda'
         else ''], sort_keys=True).encode())
    for path in sorted(glob.glob(os.path.join(HERE, 'reference', '*.py'))
                       + [os.path.abspath(__file__)]):
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:32]


def fitted_leaves(params, ref_cfg, model_dev, betas, fd, fit_steps: int,
                  key: str | None, cache_dir: str | None):
    """(params with the fitted `hypo_init` and skinning net, the fit's
    last loss, read back from the cache). With a `cache_dir`, the leaves
    are read from `<cache_dir>/fit-<key>.pt` where it is there, else
    fitted and written there atomically (a temporary file, then
    `os.replace`)."""
    path = cache_dir and os.path.join(cache_dir, f'fit-{key}.pt')
    if path and os.path.exists(path):
        try:
            got = torch.load(path, map_location=fd.verts_cano.device,
                             weights_only=True)
            return (with_leaves(params, got['hypo_init'], got['skinning']),
                    float(got['loss']), True)
        except (OSError, RuntimeError, EOFError, KeyError):
            pass     # unreadable: fitted again and written anew
    params, losses = pretrain_scene(
        params, ref_cfg, model_dev,
        torch.as_tensor(betas, device=fd.verts_cano.device), fd, steps=fit_steps, seed=torch_seed(SUBJECT_SEED, 3))
    loss = float(losses[-1])
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save({'hypo_init': params['hypernet']['hypo_init'],
                    'skinning': params['skinning'], 'loss': loss}, tmp)
        os.replace(tmp, path)
    return params, loss, False


def build_scene(cfg: dict, ref_cfg, device, fit_steps: int = 800,
                cache_dir: str | None = None) -> Scene:
    """The body, the weights and the training frames, the same for every
    seed. The weights are drawn from the subject's seed and fitted
    (`fitted_leaves`, cached under `cache_dir`). With `fit_steps` 0 (the
    CPU tests, which cannot afford the fit) the random SIREN is moved by
    its median over the box instead (`lower_sdf`), so that rays still
    find a surface."""
    scene = cfg['scene']
    model = synthetic_smpl(n_verts=scene['n_verts'])
    model_dev = smpl_to_device(model, device)
    n_frames = cfg['data']['train_end_frame'] - cfg['data'][
        'train_start_frame']
    betas, poses = frame_poses(n_frames)
    trans = np.asarray(SCENE_TRANS, np.float32)
    params = init_model_params(Draws(torch_seed(SUBJECT_SEED, 2), device),
                               ref_cfg, n_latent_frames=n_frames,
                               latent_dim=cfg['model']['latent_dim'],
                               device=device)
    with torch.no_grad():
        frames = [prepare_frame(model_dev, betas, p, trans, device=device)
                  for p in poses]
    t0 = time.perf_counter()
    if fit_steps > 0:
        key = fit_key(cfg, fit_steps, torch.device(device)) \
            if cache_dir else None
        params, fit_loss, cached = fitted_leaves(
            params, ref_cfg, model_dev, betas, frames[0], fit_steps, key,
            cache_dir)
    else:
        lower_sdf(params, ref_cfg, frames[0], torch_seed(SUBJECT_SEED, 3))
        fit_loss, cached = float('nan'), False
    return Scene(model, model_dev, params, betas, poses, trans, frames,
                 time.perf_counter() - t0, fit_loss, cached)


def near_far(bmin, bmax, ray_o, ray_d):
    """The ray-box slab test of the datasets: (near, far, hit)."""
    norm_d = torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    v = ray_d / norm_d
    v = torch.where((v < 1e-5) & (v > -1e-10), torch.full_like(v, 1e-5), v)
    v = torch.where((v > -1e-5) & (v < 1e-10), torch.full_like(v, -1e-5), v)
    tmin, tmax = (bmin - ray_o) / v, (bmax - ray_o) / v
    near = torch.minimum(tmin, tmax).amax(-1)
    far = torch.maximum(tmin, tmax).amin(-1)
    return near / norm_d[:, 0], far / norm_d[:, 0], near < far


def pixel_rays(cam: Camera, ys, xs, device):
    """Unit world rays through pixel centres (ys, xs)."""
    K_inv = torch.as_tensor(np.linalg.inv(cam.K), device=device)
    R = torch.as_tensor(cam.R, device=device)
    uv = torch.stack([xs.float() + 0.5, ys.float() + 0.5,
                      torch.ones_like(xs, dtype=torch.float32)], -1)
    d = (uv @ K_inv.T) @ R
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def box_pixels(cam: Camera, fd, device):
    """(ys, xs, dirs, near, far) of every pixel whose ray meets the
    frame's box, row-major."""
    ys, xs = torch.meshgrid(torch.arange(cam.H, device=device),
                            torch.arange(cam.W, device=device),
                            indexing='ij')
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dirs = pixel_rays(cam, ys, xs, device)
    o = torch.as_tensor(cam.loc, device=device).expand(dirs.shape)
    near, far, hit = near_far(fd.bounds_min, fd.bounds_max, o, dirs)
    return ys[hit], xs[hit], dirs[hit], near[hit], far[hit]


def eval_item(scene: Scene, cams: dict, frame: int, view: str, device):
    """Every box ray of the image of `frame` from `view`, as the
    evaluator's item holds them (numpy), and the pixel of each."""
    fd = scene.frames[frame]
    cam = cams[view]
    ys, xs, dirs, near, far = box_pixels(cam, fd, device)
    return {'inputs.ray_dirs': dirs.cpu().numpy(),
            'inputs.body_bounds_intersections':
                torch.stack([near, far], -1).cpu().numpy(),
            'image.cam_loc': cam.loc.copy(),
            'pixels': torch.stack([ys, xs], -1).cpu().numpy()}
