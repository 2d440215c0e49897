"""Free-viewpoint spiral camera path generation. Port of
`arah_tpu/utils/camera_path.py` (the reference's Neural-Body-derived
`gen_path`, `im2mesh/utils/utils.py:75-135`): a ring of world-to-camera
matrices spiralling around the capture rig, for novel-view video
rendering. Host-side numpy, float64.
"""
from __future__ import annotations

import numpy as np


def _normalize(x):
    return x / np.linalg.norm(x)


def _view_matrix(z, up, pos):
    vec2 = _normalize(z)
    vec1 = _normalize(np.cross(vec2, up))
    vec0 = _normalize(np.cross(vec1, vec2))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def gen_spiral_path(w2c_list, num_render_views: int = 50, center=None):
    """List of (4, 4) or (3, 4) world-to-camera extrinsics -> list of
    (4, 4) w2c matrices on a spiral around the rig."""
    RT = np.array([np.vstack([m[:3], [0, 0, 0, 1]]) if m.shape[0] == 3
                   else m for m in w2c_list], dtype=np.float64)
    RT = np.linalg.inv(RT)                      # camera-to-world
    RT = np.concatenate([RT[:, :, 1:2], RT[:, :, 0:1],
                         -RT[:, :, 2:3], RT[:, :, 3:4]], axis=2)

    up = _normalize(RT[:, :3, 0].sum(0))
    z = _normalize(RT[0, :3, 2])
    vec1 = _normalize(np.cross(z, up))
    vec2 = _normalize(np.cross(up, vec1))
    z_off = 0.0
    if center is None:
        center = RT[:, :3, 3].mean(0)
        z_off = 1.3

    c2w = np.stack([up, vec1, vec2, center], axis=1)

    tt = np.matmul(c2w[:3, :3].T,
                   (RT[:, :3, 3] - c2w[:3, 3])[..., None])[..., 0].T
    rads = np.percentile(np.abs(tt), 80, axis=-1) * 1.3
    rads = np.array(list(rads) + [1.0])

    lower_row = np.array([[0.0, 0.0, 0.0, 1.0]])
    render_w2c = []
    for theta in np.linspace(0.0, 2 * np.pi, num_render_views + 1)[:-1]:
        cam_pos = np.array([0, np.sin(theta), np.cos(theta), 1]) * rads
        cam_pos_world = c2w[:3, :4] @ cam_pos
        z = _normalize(cam_pos_world
                       - c2w[:3, :4] @ np.array([z_off, 0, 0, 1.0]))
        mat = _view_matrix(z, up, cam_pos_world)
        mat = np.concatenate([mat[:, 1:2], mat[:, 0:1],
                              -mat[:, 2:3], mat[:, 3:4]], axis=1)
        mat = np.concatenate([mat, lower_row], axis=0)
        render_w2c.append(np.linalg.inv(mat))
    return render_w2c
