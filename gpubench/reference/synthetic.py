"""Synthetic SMPL-like assets (numpy only) for tests and the chip smoke
run: one capsule mesh per bone, skinning weights from point-segment
distances, a J_regressor and random blend shapes of SMPL's shapes and
dtypes: a frozen copy of the port's `data/synthetic.py`; it returns
float32/int32 numpy arrays, which `model.prepare_frame` moves to the
device."""
from __future__ import annotations

import numpy as np

from gpubench.reference.smpl import SMPL_PARENTS, NUM_JOINTS, SmplModel

# T-pose joint locations of a rough humanoid (x right, y up, z forward)
_JOINTS = np.array([
    [0.00, 0.00, 0.00],    # 0 pelvis
    [0.09, -0.07, 0.00],   # 1 L hip
    [-0.09, -0.07, 0.00],  # 2 R hip
    [0.00, 0.12, 0.00],    # 3 spine1
    [0.10, -0.45, 0.00],   # 4 L knee
    [-0.10, -0.45, 0.00],  # 5 R knee
    [0.00, 0.25, 0.00],    # 6 spine2
    [0.10, -0.85, 0.00],   # 7 L ankle
    [-0.10, -0.85, 0.00],  # 8 R ankle
    [0.00, 0.32, 0.00],    # 9 spine3
    [0.11, -0.92, 0.10],   # 10 L foot
    [-0.11, -0.92, 0.10],  # 11 R foot
    [0.00, 0.47, 0.00],    # 12 neck
    [0.07, 0.42, 0.00],    # 13 L collar
    [-0.07, 0.42, 0.00],   # 14 R collar
    [0.00, 0.58, 0.00],    # 15 head
    [0.18, 0.43, 0.00],    # 16 L shoulder
    [-0.18, 0.43, 0.00],   # 17 R shoulder
    [0.42, 0.42, 0.00],    # 18 L elbow
    [-0.42, 0.42, 0.00],   # 19 R elbow
    [0.66, 0.42, 0.00],    # 20 L wrist
    [-0.66, 0.42, 0.00],   # 21 R wrist
    [0.74, 0.42, 0.00],    # 22 L hand
    [-0.74, 0.42, 0.00],   # 23 R hand
], dtype=np.float64)

_BONE_RADIUS = 0.055


def _capsule_mesh(a, b, radius, n_seg=6, n_rings=3):
    """Capsule (cylinder + cone caps) mesh from a to b. Returns (V, F)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    axis = b - a
    length = np.linalg.norm(axis)
    if length < 1e-8:
        axis = np.array([0.0, 1e-6, 0.0])
        length = 1e-6
    z = axis / length
    x = np.cross(z, [0.0, 0.0, 1.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)

    verts = [a - z * radius * 0.5]            # bottom tip
    rings = []
    for r in range(n_rings):
        t = (r + 0.5) / n_rings
        center = a + axis * t
        for s in range(n_seg):
            th = 2 * np.pi * s / n_seg
            verts.append(center + radius * (np.cos(th) * x + np.sin(th) * y))
        rings.append(list(range(1 + r * n_seg, 1 + (r + 1) * n_seg)))
    top = len(verts)
    verts.append(b + z * radius * 0.5)        # top tip

    faces = []
    for s in range(n_seg):
        faces.append([0, rings[0][(s + 1) % n_seg], rings[0][s]])
    for r in range(n_rings - 1):
        for s in range(n_seg):
            s2 = (s + 1) % n_seg
            faces.append([rings[r][s], rings[r][s2], rings[r + 1][s]])
            faces.append([rings[r][s2], rings[r + 1][s2], rings[r + 1][s]])
    for s in range(n_seg):
        faces.append([top, rings[-1][s], rings[-1][(s + 1) % n_seg]])
    return np.asarray(verts), np.asarray(faces, np.int64)


def synthetic_smpl(n_verts: int = 1536, n_betas: int = 10,
                   seed: int = 0) -> SmplModel:
    """A synthetic humanoid SmplModel of numpy arrays."""
    rng = np.random.RandomState(seed)

    bones = [(j, int(SMPL_PARENTS[j])) for j in range(1, NUM_JOINTS)]
    n_seg = 6
    n_rings = max(2, int(round((n_verts / len(bones) - 2) / n_seg)))
    verts, faces = [], []
    for j, p in bones:
        v, f = _capsule_mesh(_JOINTS[p], _JOINTS[j], _BONE_RADIUS,
                             n_seg=n_seg, n_rings=n_rings)
        faces.append(f + sum(len(vv) for vv in verts))
        verts.append(v)
    verts = np.concatenate(verts, axis=0)
    faces_arr = np.concatenate(faces, axis=0).astype(np.int32)
    n_verts = len(verts)

    def seg_dist(p, a, b):
        ab = b - a
        tt = np.clip(((p - a) @ ab) / max(ab @ ab, 1e-9), 0.0, 1.0)
        return np.linalg.norm(p - (a + tt[:, None] * ab), axis=-1)

    d = np.zeros((n_verts, NUM_JOINTS))
    for j in range(NUM_JOINTS):
        p = int(SMPL_PARENTS[j])
        a = _JOINTS[p] if p >= 0 else _JOINTS[j]
        d[:, j] = seg_dist(verts, a, _JOINTS[j])
    logits = -d / 0.02
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    w /= w.sum(axis=1, keepdims=True)

    Jr = np.zeros((NUM_JOINTS, n_verts))
    for j in range(NUM_JOINTS):
        dist = np.linalg.norm(verts - _JOINTS[j], axis=-1)
        idx = np.argsort(dist)[:24]
        ww = 1.0 / (dist[idx] + 1e-3)
        Jr[j, idx] = ww / ww.sum()

    shapedirs = rng.randn(n_verts, 3, n_betas) * 0.01
    posedirs = rng.randn(23 * 9, n_verts * 3) * 0.001

    return SmplModel(
        v_template=verts.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=Jr.astype(np.float32),
        lbs_weights=w.astype(np.float32),
        parents=SMPL_PARENTS.copy(),
        faces=faces_arr,
    )
