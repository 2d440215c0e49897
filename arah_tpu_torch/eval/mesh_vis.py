"""Canonical-mesh extraction and normal-map rendering for test-time
visualization. Port of `arah_tpu/eval/mesh_vis.py` (the reference's
mesh branch, `im2mesh/metaavatar_render/models/__init__.py:203-311`):
the marching-cubes mesh of the generated canonical SDF (its grid on
kernel J, `utils/meshing.py`), forward-LBS skinning of the vertices to
posed space through the plain skinning MLP, then the port's native
z-buffer rasterization of (a) the posed mesh under the frame's camera and
(b) the canonical mesh from the front and the back.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from arah_tpu_torch import native
from arah_tpu_torch.core.body import unnormalize_canonical_points
from arah_tpu_torch.render.renderer import (ModelConfig, generate_sdf,
                                            make_skin_fn)
from arah_tpu_torch.solver.root_find import forward_skinning
from arah_tpu_torch.utils.meshing import extract_mesh

SKIN_CHUNK = 100000     # vertices a forward-skinning call


def face_normals(verts, faces):
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n


def _normal_image(face_buf, normals_rgb, bg=0.0):
    H, W = face_buf.shape
    img = np.full((H, W, 3), bg, np.float32)
    fg = face_buf >= 0
    img[fg] = normals_rgb[face_buf[fg]]
    return img


def _add(times, key, t0):
    if times is not None:
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0


def render_normal_maps(params, cfg: ModelConfig, fd, item, latent,
                       resolution: int = 256, img_size: int = 512,
                       times: dict | None = None):
    """Returns (posed_normal, cano_front, cano_back) images in [0, 1],
    float32 (H, W, 3), (img_size, img_size, 3) twice (all three blank at
    img_size for an empty mesh). `times`, a dict, gains the seconds of
    'grid', 'marching_cubes', 'skinning' and 'rasterize'."""
    with torch.no_grad():
        gen = generate_sdf(params, cfg, fd.rots, fd.Jtrs, latent)
    verts_n, faces = extract_mesh(gen, resolution, times=times)
    if len(verts_n) == 0:
        blank = np.zeros((img_size, img_size, 3), np.float32)
        return blank, blank, blank
    posed = posed_normal_map(params, cfg, fd, item, verts_n, faces, times)
    t0 = time.perf_counter()
    front, back = canonical_normal_maps(verts_n, faces, img_size)
    _add(times, 'rasterize', t0)
    return posed, front, back


def posed_normal_map(params, cfg: ModelConfig, fd, item, verts_n, faces,
                     times: dict | None = None):
    """The canonical mesh (verts_n (V, 3) in [-1, 1]^3, faces (F, 3))
    forward-skinned into the frame's pose and rasterized under the item's
    camera: camera-frame normals in [0, 1], (H, W, 3), 0 on the
    background (reference `:244-267`). `times` gains 'skinning' and
    'rasterize'."""
    # canonical (metric) -> posed via the skinning network
    t0 = time.perf_counter()
    frame = fd.frame
    skin_fn = make_skin_fn(params, cfg)
    posed = []
    with torch.no_grad():
        verts_hat = unnormalize_canonical_points(
            torch.as_tensor(verts_n, device=frame.trans.device),
            frame.coord_min, frame.coord_max, frame.center)
        for i in range(0, verts_hat.shape[0], SKIN_CHUNK):
            xb, _ = forward_skinning(skin_fn, frame,
                                     verts_hat[i:i + SKIN_CHUNK])
            posed.append(xb.cpu().numpy())
    verts_posed = np.concatenate(posed, 0) + frame.trans.cpu().numpy()
    _add(times, 'skinning', t0)

    t0 = time.perf_counter()
    K = np.asarray(item['image.K'])
    R = np.asarray(item['image.R'])
    T = np.asarray(item['image.T']).reshape(3)
    pc = verts_posed @ R.T + T
    depth = np.maximum(pc[:, 2], 1e-6)
    proj = pc[:, :2] / depth[:, None]
    proj = proj * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    H = int(item['inputs.img_height'])
    W = int(item['inputs.img_width'])
    face_buf, _, _ = native.rasterize_mesh(proj, depth, faces, H, W)
    fn_posed = face_normals(verts_posed, faces)
    # camera-frame normals, -1 background (reference `:259-265`)
    fn_cam = (-fn_posed) @ R.T
    posed_img = _normal_image(face_buf, (fn_cam + 1) / 2, bg=0.0)
    posed_img[face_buf < 0] = 0.0
    _add(times, 'rasterize', t0)
    return posed_img


def canonical_normal_maps(verts_n, faces, img_size: int = 512):
    """The canonical mesh's front and back orthographic normal maps,
    (img_size, img_size, 3) each (reference `:269-311`)."""
    fn_cano = face_normals(verts_n, faces)

    def ortho_view(flip: bool):
        v = verts_n.copy()
        n = fn_cano.copy()
        if flip:
            v = v * np.array([-1, 1, -1], np.float32)
            n = n * np.array([-1, 1, -1], np.float32)
        scale = img_size / 2.4
        proj = np.stack([v[:, 0], -v[:, 1]], -1) * scale + img_size / 2
        depth = v[:, 2] + 10.0
        fb, _, _ = native.rasterize_mesh(proj, depth, faces, img_size,
                                         img_size)
        return _normal_image(fb, ((n * [1, 1, -1]) + 1) / 2, bg=0.0)

    return ortho_view(False), ortho_view(True)
