"""Full-image evaluation. Port of `arah_tpu/eval/evaluator.py` on one
device: render every box ray of a frame in fixed-size chunks with
`render(training=False)` (kernels A-F on the card, under `torch.no_grad`),
scatter the rays back into the image by the box mask, derive a normal
image from finite-difference depth, and compute PSNR/SSIM and the
perceptual metric; PNGs through the port's writer (`utils/image.py`).
`write_video` writes an MP4 of Motion-JPEG samples (`read_video` reads
it back), where JAX's OpenCV writer encodes MPEG-4 Part 2 (`mp4v`): the
card's machine has neither OpenCV nor an MPEG-4 encoder. The sharded
chunk path is not ported."""
from __future__ import annotations

import struct

import numpy as np
import torch

from arah_tpu_torch.data.loader import frame_from_item
from arah_tpu_torch.render.renderer import ModelConfig, RenderInputs, render
from arah_tpu_torch.utils import metrics as metrics_lib
from arah_tpu_torch.utils.image import write_image, write_jpeg

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


# ------------------------------------------------------------- the video
def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b''.join(parts)
    return struct.pack('>I', 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes):
    return _box(kind, struct.pack('>I', version << 24 | flags), *parts)


# the unity transform of mvhd and tkhd (16.16 and 2.30 fixed point)
_MATRIX = struct.pack('>9I', 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                      0x40000000)


def write_video(path, frames, fps: int = 20, quality: int = 95):
    """An ISO-BMFF MP4 of one Motion-JPEG video track (sample entry
    'jpeg'), one sample a frame, each `utils/image.py:write_jpeg` of the
    frame: uint8 (H, W, 3) RGB as it is, a float image in [0, 1] as
    `save_image` quantises it. Writes nothing for no frames."""
    if not frames:
        return
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError('write_video: frames of different sizes')
    samples = [write_jpeg(f if f.dtype == np.uint8 else _to_u8(f), quality)
               for f in frames]
    n = len(samples)
    if sum(map(len, samples)) >= 1 << 32:
        raise ValueError('write_video: over 4 GiB of samples')
    ftyp = _box(b'ftyp', b'isom', struct.pack('>I', 0x200),
                b'isom', b'iso2', b'mp41')
    mvhd = _full_box(b'mvhd', 0, 0, struct.pack('>5I', 0, 0, fps, n,
                                                0x10000),
                     struct.pack('>H', 0x100), bytes(10), _MATRIX,
                     bytes(24), struct.pack('>I', 2))
    tkhd = _full_box(b'tkhd', 0, 3, struct.pack('>5I', 0, 0, 1, 0, n),
                     bytes(8), struct.pack('>4H', 0, 0, 0, 0), _MATRIX,
                     struct.pack('>2I', w << 16, h << 16))
    mdhd = _full_box(b'mdhd', 0, 0, struct.pack('>4I', 0, 0, fps, n),
                     struct.pack('>2H', 0x55C4, 0))   # language 'und'
    hdlr = _full_box(b'hdlr', 0, 0, bytes(4), b'vide', bytes(12),
                     b'VideoHandler\0')
    vmhd = _full_box(b'vmhd', 0, 1, bytes(8))
    dinf = _box(b'dinf', _full_box(b'dref', 0, 0, struct.pack('>I', 1),
                                   _full_box(b'url ', 0, 1)))
    name = b'Photo - JPEG'
    entry = _box(b'jpeg', bytes(6), struct.pack('>H', 1), bytes(16),
                 struct.pack('>2H2I', w, h, 0x480000, 0x480000), bytes(4),
                 struct.pack('>H', 1), bytes([len(name)]) + name
                 + bytes(31 - len(name)), struct.pack('>Hh', 24, -1))
    stsd = _full_box(b'stsd', 0, 0, struct.pack('>I', 1), entry)
    stts = _full_box(b'stts', 0, 0, struct.pack('>3I', 1, n, 1))
    stsc = _full_box(b'stsc', 0, 0, struct.pack('>4I', 1, 1, n, 1))
    stsz = _full_box(b'stsz', 0, 0, struct.pack('>2I', 0, n),
                     struct.pack(f'>{n}I', *map(len, samples)))

    def moov(offset):
        stco = _full_box(b'stco', 0, 0, struct.pack('>2I', 1, offset))
        stbl = _box(b'stbl', stsd, stts, stsc, stsz, stco)
        minf = _box(b'minf', vmhd, dinf, stbl)
        trak = _box(b'trak', tkhd, _box(b'mdia', mdhd, hdlr, minf))
        return _box(b'moov', mvhd, trak)
    # the samples start after ftyp, moov and mdat's 8-byte header
    offset = len(ftyp) + len(moov(0)) + 8
    with open(path, 'wb') as f:
        f.write(ftyp + moov(offset))
        f.write(struct.pack('>I', 8 + sum(map(len, samples))) + b'mdat')
        for s in samples:
            f.write(s)


def _boxes(data: bytes, pos: int, end: int):
    """(kind, body start, body end) of each box in data[pos:end]."""
    while pos < end:
        size, kind = struct.unpack('>I4s', data[pos:pos + 8])
        if size < 8 or pos + size > end:
            raise ValueError(f'MP4 box {kind!r} of size {size} at {pos}')
        yield kind, pos + 8, pos + size
        pos += size


def read_video(path):
    """The samples of `write_video`'s file: (list of JPEG bytes, fps,
    (width, height)). Walks the boxes moov/trak/mdia/minf/stbl and reads
    the sample table (stsd 'jpeg', stts, stsc, stsz, stco); raises
    ValueError on anything else."""
    with open(path, 'rb') as f:
        data = f.read()
    top = {k: (a, b) for k, a, b in _boxes(data, 0, len(data))}
    if data[8:12] != b'isom' or b'moov' not in top or b'mdat' not in top:
        raise ValueError(f'{path}: not an MP4 of ftyp isom, moov, mdat')

    def child(span, *path_):
        for name in path_:
            kids = {k: (a, b) for k, a, b in _boxes(data, *span)}
            if name not in kids:
                raise ValueError(f'{path}: no {name!r} box')
            span = kids[name]
        return span
    a, _ = child(top[b'moov'], b'mvhd')
    fps = struct.unpack('>I', data[a + 12:a + 16])[0]
    stbl = child(top[b'moov'], b'trak', b'mdia', b'minf', b'stbl')
    a, _ = child(stbl, b'stsd')
    kind = data[a + 12:a + 16]
    w, h = struct.unpack('>2H', data[a + 40:a + 44])
    if kind != b'jpeg':
        raise ValueError(f'{path}: sample entry {kind!r}, not jpeg')
    a, _ = child(stbl, b'stsz')
    size, n = struct.unpack('>2I', data[a + 4:a + 12])
    sizes = [size] * n if size else list(
        struct.unpack(f'>{n}I', data[a + 12:a + 12 + 4 * n]))
    a, _ = child(stbl, b'stts')
    deltas = []
    for e in range(struct.unpack('>I', data[a + 4:a + 8])[0]):
        cnt, delta = struct.unpack('>2I', data[a + 8 + 8 * e:a + 16 + 8 * e])
        deltas += [delta] * cnt
    if len(deltas) != n:
        raise ValueError(f'{path}: stts counts {len(deltas)} of {n} samples')
    a, _ = child(stbl, b'stco')
    n_chunks = struct.unpack('>I', data[a + 4:a + 8])[0]
    offsets = struct.unpack(f'>{n_chunks}I', data[a + 8:a + 8 + 4 * n_chunks])
    a, _ = child(stbl, b'stsc')
    runs = [struct.unpack('>3I', data[a + 8 + 12 * e:a + 20 + 12 * e])
            for e in range(struct.unpack('>I', data[a + 4:a + 8])[0])]
    out, s = [], 0
    for c, off in enumerate(offsets, start=1):
        per = [r[1] for r in runs if r[0] <= c][-1]
        for _ in range(per):
            out.append(data[off:off + sizes[s]])
            off += sizes[s]
            s += 1
    if s != n:
        raise ValueError(f'{path}: stsc places {s} of {n} samples')
    return out, fps, (w, h)
