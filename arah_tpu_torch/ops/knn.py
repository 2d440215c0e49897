"""Nearest-SMPL-vertex queries: kernels A and K and their plain version.

`nn_idx` launches kernel A (`arah_knn` in csrc/knn.cu, the port of
`arah_tpu/ops/pallas/knn_kernel.py:nn_idx_pallas_t`) and `nn_idx_rows`
kernel K (`arah_knn_rows`, the port of `knn_kernel.py:nn_idx_pallas`) for
CUDA tensors; both compute `nn_idx_plain` (the port of
`arah_tpu/ops/knn.py:nn_idx`) for CPU tensors. All use the expanded
distance |v|^2 - 2 v.x and resolve ties to the first vertex.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.ops import _build


def nn_idx_plain(points: torch.Tensor, verts: torch.Tensor,
                 chunk: int = 16384) -> torch.Tensor:
    """(N, 3) points, (V, 3) verts -> (N,) int32 nearest-vertex indices,
    in point chunks so the (N, V) distance matrix stays small. Each
    product and sum is its own rounded operation, in the kernel's order
    (csrc/knn.cu), so near-ties resolve alike on the card."""
    vx, vy, vz = verts[:, 0], verts[:, 1], verts[:, 2]
    v_sq = vx * vx + vy * vy + vz * vz
    out = []
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        dot = p[:, 0:1] * vx + p[:, 1:2] * vy + p[:, 2:3] * vz
        out.append(torch.argmin(v_sq - 2.0 * dot, dim=-1))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=points.device)
    return torch.cat(out).to(torch.int32)


def _launch(entry: str, points: torch.Tensor,
            verts: torch.Tensor) -> torch.Tensor:
    n, v = points.shape[0], verts.shape[0]
    _build.require(points, 'points', torch.float32, (n, 3))
    _build.require(verts, 'verts', torch.float32, (v, 3))
    lib = _build.load()
    out = torch.empty((n,), dtype=torch.int32, device=points.device)
    _build.check(getattr(lib, 'arah_' + entry)(
        points.data_ptr(), n, verts.data_ptr(), v, out.data_ptr(),
        _build.stream_ptr(points)), entry)
    _build.COUNTS[entry] += 1
    return out


def nn_idx(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Kernel A: (N, 3) x (V, 3) -> (N,) int32 nearest-vertex indices."""
    if not points.is_cuda:
        return nn_idx_plain(points, verts)
    return _launch('knn', points, verts)


def nn_idx_rows(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Kernel K (`arah_knn_rows` in csrc/knn.cu, the port of
    `knn_kernel.py:nn_idx_pallas`): the same function as kernel A, the
    vertex axis reduced across a warp's lanes."""
    if not points.is_cuda:
        return nn_idx_plain(points, verts)
    return _launch('knn_rows', points, verts)
