"""Nearest-SMPL-vertex queries: kernels A and K and their plain version.

`nn_idx` (kernel A, the port of
`arah_tpu/ops/pallas/knn_kernel.py:nn_idx_pallas_t`) and `nn_idx_rows`
(kernel K, the port of `knn_kernel.py:nn_idx_pallas`) launch one CUDA
body, `arah_knn` in csrc/knn.cu, for CUDA tensors, at the launch shape
`launch_shape` picks by the number of points; the two count their
launches apart ('knn', 'knn_rows'). For CPU tensors both compute
`nn_idx_plain` (the port of `arah_tpu/ops/knn.py:nn_idx`). All use the
expanded distance |v|^2 - 2 v.x, in the form |v|^2 - (x.(2 v)), and
resolve ties to the first vertex.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.ops import _build
from arah_tpu_torch.utils import trace

# (threads, points a thread, vertex groups a CTA, cluster size) of
# csrc/knn.cu's launch shapes, in the order of its dispatch.
SHAPES = ((256, 8, 1, 1), (256, 4, 8, 2), (256, 2, 8, 4))


def nn_idx_plain(points: torch.Tensor, verts: torch.Tensor,
                 chunk: int = 16384) -> torch.Tensor:
    """(N, 3) points, (V, 3) verts -> (N,) int32 nearest-vertex indices,
    in point chunks so the (N, V) distance matrix stays small. The kernel's
    form and order (csrc/knn.cu): |v|^2 - (x 2vx + y 2vy + z 2vz), each
    product and sum its own rounded operation (doubling is exact, so these
    are the bits of |v|^2 - 2 v.x), so near-ties resolve alike on the
    card."""
    vx, vy, vz = verts[:, 0], verts[:, 1], verts[:, 2]
    v_sq = vx * vx + vy * vy + vz * vz
    v2 = 2.0 * verts
    v2x, v2y, v2z = v2[:, 0], v2[:, 1], v2[:, 2]
    out = []
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        dot2 = p[:, 0:1] * v2x + p[:, 1:2] * v2y + p[:, 2:3] * v2z
        out.append(torch.argmin(v_sq - dot2, dim=-1))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=points.device)
    return torch.cat(out).to(torch.int32)


def launch_shape(n: int) -> int:
    """The launch shape of kernels A and K for n points: 0 (two CTAs an
    SM, each scanning every vertex for 2,048 points a tile) for the corr
    init's hundreds of thousands, 1 (clusters of 2) for thousands, 2
    (clusters of 4) for the plain loops' phase-2 batches (csrc/knn.cu;
    chosen by a sweep on the H100, PERF.md)."""
    return 0 if n > 196608 else (1 if n > 4096 else 2)


def check_shape(shape: int):
    """Raise ValueError unless csrc/knn.cu builds launch shape `shape`."""
    if not 0 <= shape < len(SHAPES):
        raise ValueError(f'knn kernel: no launch shape {shape}')


def launch_knn(points: torch.Tensor, verts: torch.Tensor, shape: int,
               counter: str = 'knn') -> torch.Tensor:
    """One launch of the nearest-vertex body at launch shape `shape` on
    (N, 3) and (V, 3) f32 CUDA tensors; adds one to `COUNTS[counter]`."""
    check_shape(shape)
    n, v = points.shape[0], verts.shape[0]
    _build.require(points, 'points', torch.float32, (n, 3))
    _build.require(verts, 'verts', torch.float32, (v, 3))
    if v < 1:
        raise ValueError('knn kernel: no vertices')
    out = torch.empty((n,), dtype=torch.int32, device=points.device)
    _build.check(_build.load().arah_knn(
        points.data_ptr(), n, verts.data_ptr(), v, int(shape),
        out.data_ptr(), _build.stream_ptr(points)), counter)
    trace.COUNTS[counter] += 1
    return out


def knn_shape(shape: int, n: int, v: int) -> dict:
    """The launch of shape `shape` for n points and v vertices: blocks,
    cluster size, points a tile, dynamic shared memory a CTA and CTAs
    resident an SM (the card's occupancy query; nothing launched)."""
    check_shape(shape)
    out = (_build.ctypes.c_int * 5)()
    _build.check(_build.load().arah_knn_shape(shape, n, v, out), 'knn')
    return dict(zip(('blocks', 'cluster', 'points', 'smem', 'per_sm'), out))


def nn_idx(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Kernel A: (N, 3) x (V, 3) -> (N,) int32 nearest-vertex indices."""
    if not points.is_cuda:
        return nn_idx_plain(points, verts)
    return launch_knn(points, verts, launch_shape(points.shape[0]), 'knn')


def nn_idx_rows(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Kernel K: the same function as kernel A on the tracer's A/B path
    (the port of `knn_kernel.py:nn_idx_pallas`), counted apart."""
    if not points.is_cuda:
        return nn_idx_plain(points, verts)
    return launch_knn(points, verts, launch_shape(points.shape[0]),
                      'knn_rows')
