"""Canonical-mesh extraction from the generated SDF. Port of
`arah_tpu/utils/meshing.py` (reference `im2mesh/utils/sdf_meshing.py`):
evaluate the generated SIREN on a dense [-1, 1]^3 grid in fixed chunks,
then run the port's native marching-cubes extractor on the host.

On a CUDA device each chunk is one launch of kernel J
(`ops/siren.py:siren_sdf`, the port of
`arah_tpu/ops/pallas/siren_kernel.py:siren_sdf_pallas`), with the SIREN
packed once a grid; on the CPU the plain SIREN evaluates each chunk.
The chunk's points are made on the device from their grid indices, so
the device holds one chunk and the pack, whatever the resolution.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from arah_tpu_torch.nn.siren import GeneratedMLP
from arah_tpu_torch.ops.siren import pack_siren_sdf, siren_sdf

CHUNK = 64 ** 3         # points a launch of J: 262,144


def grid_chunk(resolution: int, start: int, chunk: int = CHUNK,
               device='cpu') -> torch.Tensor:
    """The points of grid indices [start, start + chunk) of the
    resolution^3 grid over [-1, 1]^3 (i-major, as np.meshgrid with
    indexing='ij' orders them), (chunk, 3) float32; indices past the grid
    are padded with the origin, as JAX pads the last chunk."""
    n = resolution
    lin = torch.as_tensor(np.linspace(-1.0, 1.0, n, dtype=np.float32),
                          device=device)
    idx = torch.arange(start, start + chunk, device=device)
    pts = torch.stack([lin[(idx // (n * n)) % n], lin[(idx // n) % n],
                       lin[idx % n]], dim=-1)
    return torch.where((idx < n ** 3)[:, None], pts, pts.new_zeros(()))


def eval_sdf_grid(gen: GeneratedMLP, resolution: int = 256,
                  chunk: int = CHUNK) -> np.ndarray:
    """The generated SIREN's SDF over the regular grid, (N, N, N) float32
    on the host, evaluated on the SIREN's device."""
    n = resolution
    dev = gen.weights[0].device
    packed = pack_siren_sdf(gen) if dev.type == 'cuda' else None
    out = np.empty((n ** 3,), np.float32)
    with torch.no_grad():
        for i in range(0, n ** 3, chunk):
            vals = siren_sdf(gen, grid_chunk(n, i, chunk, dev), packed)
            k = min(chunk, n ** 3 - i)
            out[i:i + k] = vals[:k, 0].cpu().numpy()
    return out.reshape(n, n, n)


def extract_mesh(gen: GeneratedMLP, resolution: int = 256,
                 level: float = 0.0, times: dict | None = None):
    """Marching-cubes mesh of the SDF zero set in normalized coords:
    (verts (V, 3) float32 in [-1, 1]^3, faces (F, 3) int32). `times`, a
    dict, gains the seconds of 'grid' and 'marching_cubes'."""
    from arah_tpu_torch import native
    t0 = time.perf_counter()
    grid = eval_sdf_grid(gen, resolution)
    t1 = time.perf_counter()
    spacing = 2.0 / (resolution - 1)
    verts, faces = native.marching_cubes(
        grid, level, origin=[-1.0, -1.0, -1.0], spacing=[spacing] * 3)
    if times is not None:
        times['grid'] = times.get('grid', 0.0) + t1 - t0
        times['marching_cubes'] = times.get('marching_cubes', 0.0) \
            + time.perf_counter() - t1
    return verts, faces
