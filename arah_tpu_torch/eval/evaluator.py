"""Full-image evaluation. Port of `arah_tpu/eval/evaluator.py` on one
device: render every box ray of a frame in fixed-size chunks with
`render(training=False)` (kernels A-F on the card, under `torch.no_grad`),
scatter the rays back into the image by the box mask, derive a normal
image from finite-difference depth, and compute PSNR/SSIM and the
perceptual metric; PNGs through the port's writer (`utils/image.py`).
The sharded chunk path and `write_video` are not ported."""
from __future__ import annotations

import numpy as np
import torch

from arah_tpu_torch.data.loader import frame_from_item
from arah_tpu_torch.render.renderer import ModelConfig, RenderInputs, render
from arah_tpu_torch.utils import metrics as metrics_lib
from arah_tpu_torch.utils.image import write_image

# candidate chunks and their relative eval throughput, from the JAX
# package's chunk sweep on its TPU (arah_tpu/eval/evaluator.py); only the
# ratios matter, and they are not measured on the GPU
_AUTO_CHUNKS = ((8192, 68.0), (16384, 74.4), (32768, 77.6))


def pick_eval_chunk(n_rays: int) -> int:
    """The chunk of the fixed candidates that minimises the padded work
    weighted by the candidate's relative throughput."""
    best, best_t = None, None
    for c, rate in _AUTO_CHUNKS:
        t = -(-n_rays // c) * c / rate
        if best_t is None or t < best_t:
            best, best_t = c, t
    return best


def render_frame_rays(params, cfg: ModelConfig, fd, item, latent,
                      chunk: int | None = None):
    """Render every sampled ray of an eval item on the parameters'
    device; returns numpy (rgb (N, 3), weights (N,), depth (N,),
    converged (N,)). Each chunk is padded to `chunk` rays (repeating the
    last), as in JAX; chunk=None picks `pick_eval_chunk`."""
    dev = fd.smpl.verts_posed.device
    rays = np.asarray(item['inputs.ray_dirs'], np.float32)
    bounds = np.asarray(item['inputs.body_bounds_intersections'],
                        np.float32)
    n = rays.shape[0]
    if chunk is None:
        chunk = pick_eval_chunk(n)
    pose_cond_extra = {}
    geo_latent = None
    if latent is not None:
        pose_cond_extra['latent_code'] = latent[None]
        geo_latent = latent
    cam_loc = torch.as_tensor(np.asarray(item['image.cam_loc'], np.float32)
                              .reshape(3), device=dev)

    rgb = np.zeros((n, 3), np.float32)
    weights = np.zeros((n,), np.float32)
    depth = np.zeros((n,), np.float32)
    conv = np.zeros((n,), bool)
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        pad = chunk - (j - i)
        rd = np.pad(rays[i:j], ((0, pad), (0, 0)), mode='edge')
        nr = np.pad(bounds[i:j, 0], (0, pad), mode='edge')
        fr = np.pad(bounds[i:j, 1], (0, pad), mode='edge')
        inp = RenderInputs(
            cam_loc=cam_loc, ray_dirs=torch.as_tensor(rd, device=dev),
            near=torch.as_tensor(nr, device=dev),
            far=torch.as_tensor(fr, device=dev),
            frame=fd.frame, smpl=fd.smpl, rots=fd.rots, Jtrs=fd.Jtrs,
            rots_full=fd.rots_full, Jtrs_posed=fd.Jtrs_posed,
            pose_cond_extra=pose_cond_extra, geo_latent=geo_latent)
        out = render(params, cfg, inp, training=False)
        k = j - i
        rgb[i:j] = out['rgb_values'][:k].float().cpu().numpy()
        weights[i:j] = out['weights_sum'][:k].float().cpu().numpy()
        depth[i:j] = out['surface_depth'][:k].float().cpu().numpy()
        conv[i:j] = out['surface_converged'][:k].cpu().numpy()
    return rgb, weights, depth, conv


def scatter_image(values, image_mask, fill=0.0):
    """(N, C) ray values -> (H, W, C) image via the bool box mask."""
    H, W = image_mask.shape
    c = values.shape[-1] if values.ndim == 2 else 1
    img = np.full((H, W, c), fill, np.float32)
    img[image_mask] = values.reshape(-1, c)
    return img.squeeze(-1) if c == 1 else img


def normals_from_depth(points_cam, image_mask):
    """Finite-difference normal image from camera-space surface points."""
    H, W = image_mask.shape
    pred_points = scatter_image(points_cam, image_mask)
    zs, xs, ys = (pred_points[..., 2], pred_points[..., 0],
                  pred_points[..., 1])
    with np.errstate(divide='ignore', invalid='ignore'):
        zy = (zs[1:, :] - zs[:-1, :]) / (ys[1:, :] - ys[:-1, :])
        zx = (zs[:, 1:] - zs[:, :-1]) / (xs[:, 1:] - xs[:, :-1])
    normals = np.zeros((H, W, 3), np.float32)
    normals[:-1, :, 1] = -zy
    normals[:, :-1, 0] = -zx
    normals[:, :, 2] = 1.0
    n = np.linalg.norm(normals, axis=-1, keepdims=True)
    with np.errstate(divide='ignore', invalid='ignore'):
        normals = normals / n
    normals[~np.isfinite(normals)] = -1
    return ((normals + 1) / 2).clip(0, 1)


def evaluate_frame(params, cfg: ModelConfig, item, latent=None,
                   chunk: int | None = None):
    """Validation metrics of one eval item on the parameters' device:
    psnr, ssim, the perceptual metric under `utils/lpips.py:metric_key`,
    and the rendered images."""
    from arah_tpu_torch.utils.lpips import metric_key
    dev = params['deviation']['variance'].device
    fd = frame_from_item(item, dev)
    rgb, weights, depth, conv = render_frame_rays(
        params, cfg, fd, item, latent, chunk=chunk)
    image_mask = np.asarray(item['inputs.image_mask'])
    gt = np.asarray(item['inputs'])

    pred_img = scatter_image(rgb, image_mask)
    gt_img = scatter_image(gt, image_mask)

    # camera-space surface points for the normal image
    cam_loc = np.asarray(item['image.cam_loc']).reshape(3)
    rays = np.asarray(item['inputs.ray_dirs'])
    pts_world = cam_loc + depth[:, None] * rays
    R = np.asarray(item['image.R'])
    T = np.asarray(item['image.T']).reshape(3)
    pts_cam = pts_world @ R.T + T
    pts_cam[~conv] = 0
    normal_img = normals_from_depth(pts_cam, image_mask)

    return {
        'psnr': metrics_lib.psnr(rgb, gt),
        'ssim': metrics_lib.ssim_metric(pred_img, gt_img, image_mask),
        metric_key(): metrics_lib.lpips_metric(pred_img, gt_img,
                                               image_mask),
        'rgb_pred': pred_img, 'rgb_gt': gt_img, 'normal_pred': normal_img,
    }


def _to_u8(img):
    return (np.clip(np.nan_to_num(img), 0, 1) * 255).astype(np.uint8)


def save_image(path, img):
    """A float RGB image in [0, 1] as an 8-bit PNG."""
    write_image(path, _to_u8(img))
