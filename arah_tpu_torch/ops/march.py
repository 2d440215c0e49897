"""Fused sphere-trace march: kernel E and its plain version.

`sphere_march` launches the CUDA kernel (csrc/march.cu, the port of
`arah_tpu/ops/pallas/march_kernel.py:sphere_march_pallas`) for CUDA
tensors and computes `sphere_march_plain` for CPU tensors. Both follow
the Pallas kernel, not `_march_xla`: nearest-vertex ties average their
skinning weights, the distance is the expanded |v|^2 - 2 v.p (each product
and sum rounded on its own, in the order of `ops/knn.py`), the blended
rotation is inverted by its adjugate (`core/linalg.py:inv3x3`), and
points are normalised in the kernel's `nscale`/`noffset` form.

Kernels E and F take one parameter buffer, `pack_trace` (the generated
SIREN and, for F, the collapsed skinning MLP), which the tracer builds
once a trace and hands to both phases of both kernels; `launch_shape`
picks their launch shape from the number of rays.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from arah_tpu_torch.core.linalg import inv3x3
from arah_tpu_torch.nn.siren import GeneratedMLP, siren_apply
from arah_tpu_torch.ops import _build
from arah_tpu_torch.solver.root_find import CanonicalFrame
from arah_tpu_torch.utils import trace


def kernel_affine(frame: CanonicalFrame):
    """(nscale, noffset (3,), metric scale) of the Pallas kernels:
    x_norm = x * nscale + noffset, metric sdf = sdf * metric scale."""
    ext = frame.coord_max - frame.coord_min
    nscale = 2.0 / (ext * 1.1)
    noffset = (-frame.center - frame.coord_min + 0.05 * ext) * nscale - 1.0
    return nscale, noffset, 0.55 * ext


def nn_weights_tied(points: torch.Tensor, verts: torch.Tensor,
                    skin_weights: torch.Tensor,
                    chunk: int = 4096) -> torch.Tensor:
    """(N, 24) skinning weights of each point's nearest vertex; when
    several vertices tie at the minimum distance, the mean of their rows
    (`march_kernel.py:100-104`)."""
    vx, vy, vz = verts[:, 0], verts[:, 1], verts[:, 2]
    v_sq = vx * vx + vy * vy + vz * vz
    out = []
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        dot = p[:, 0:1] * vx + p[:, 1:2] * vy + p[:, 2:3] * vz
        d = v_sq - 2.0 * dot
        dmin, idx = torch.min(d, dim=-1)
        tie = d <= dmin[:, None]
        cnt = tie.sum(-1, keepdim=True)
        # a tied row's sum of 1.0 * row + 0.0 * others is exact
        mean = (tie.to(skin_weights.dtype) @ skin_weights) \
            / cnt.clamp(min=1)
        out.append(torch.where(cnt > 1, mean, skin_weights[idx]))
    if not out:
        return skin_weights.new_zeros((0, skin_weights.shape[1]))
    return torch.cat(out)


@torch.no_grad()
def sphere_march_plain(cam, dirs, near, far, verts, skin_weights,
                       frame: CanonicalFrame, gen: GeneratedMLP,
                       n_iters: int = 50, thresh: float = 1e-5,
                       clamp_dist: float = 0.1):
    """Plain version of kernel E. Returns (t (N,), unfinished (N,),
    diverged (N,), x_norm (N, 3), T16 (N, 16), iters (N,) int32: the
    iterations each ray ran)."""
    n = dirs.shape[0]
    dev = dirs.device
    nscale, noffset, mscale = kernel_affine(frame)
    bones16 = frame.bone_transforms.reshape(24, 16)
    t = near.clone()
    unf = near < far
    div = ~unf
    x_norm = torch.zeros((n, 3), device=dev)
    T16 = torch.zeros((n, 16), device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    big = torch.tensor(1e11, device=dev)
    i = 0
    while i < n_iters and bool(unf.any()):
        pts = cam + t[:, None] * dirs
        T = nn_weights_tied(pts, verts, skin_weights) @ bones16
        T4 = T.reshape(n, 4, 4)
        x_hat = torch.einsum('nij,nj->ni', inv3x3(T4[:, :3, :3]),
                             (pts - frame.trans) - T4[:, :3, 3])
        xn = x_hat * nscale + noffset
        sdf = siren_apply(gen, xn)[:, 0] * mscale
        sdf = torch.where(unf, sdf, big)
        x_norm = torch.where(unf[:, None], xn, x_norm)
        T16 = torch.where(unf[:, None], T, T16)
        sdf_march = torch.clamp(sdf, -clamp_dist, clamp_dist)
        update = (torch.abs(sdf_march) > thresh) & (torch.abs(sdf) < 1e6)
        t = torch.where(update, t + sdf_march, t)
        div = torch.where(update, t >= far, div)
        remove = (unf & (torch.abs(sdf) <= thresh)) | div
        iters += unf.int()
        unf = unf & ~remove
        i += 1
    return t, unf, div, x_norm, T16, iters


def frame_vec(frame: CanonicalFrame) -> torch.Tensor:
    """(8,) [coord_min, coord_max, center (3), trans (3)] for the kernels."""
    return torch.cat([frame.coord_min.reshape(1), frame.coord_max.reshape(1),
                      frame.center.reshape(3),
                      frame.trans.reshape(3)]).float().contiguous()


def pack_siren(gen: GeneratedMLP, pack: _build.ParamPack,
               name: str = 'march/iso kernel', max_out: int = 1,
               align: int = 1) -> dict:
    """Put a generated SIREN (3 -> hidden ... -> out, out <= max_out) into
    `pack`, each block at a multiple of `align` floats; returns the SIREN
    fields of `NetMeta` (hidden layers as (in, hidden) transposed copies,
    the output layer's (out, hidden) rows at `wl_off`). Raises on a shape
    the kernels do not take."""
    L = len(gen.weights)
    H = gen.weights[0].shape[0]
    if (L < 2 or L > 8 or gen.weights[0].shape[1] != 3
            or not 1 <= gen.weights[-1].shape[0] <= max_out or H % 4
            or H > 256
            or any(tuple(w.shape) != (H, H) for w in gen.weights[1:-1])):
        raise ValueError(f'{name}: unsupported SIREN shape '
                         f'{[tuple(w.shape) for w in gen.weights]}')
    film = len(gen.freqs) > 0
    LL = _build.ctypes.c_longlong * 8

    def put(t):
        return pack.put(t, align)
    return dict(
        n_layers=L, hidden=H, film=int(film),
        wt_off=LL(*[put(w.T.contiguous()) for w in gen.weights[:-1]]),
        wl_off=put(gen.weights[-1]),
        b_off=LL(*[put(b) for b in gen.biases]),
        freq_off=put(torch.stack(gen.freqs)) if film else 0,
        phase_off=put(torch.stack(gen.phases)) if film else 0)


class TracePack(NamedTuple):
    """The parameter buffer of kernels E and F and its `NetMeta`."""
    params: torch.Tensor
    meta: _build.NetMeta


def put_skin_padded(pack: _build.ParamPack, skin_weights,
                    skin_biases) -> dict:
    """Put a collapsed skinning MLP (dense (out, in) weights, (out,)
    biases) into `pack`, the layout of kernels F and G: per layer the (in,
    out) transposed weights and the bias, with out zero-padded to a
    multiple of 32 (the 25 logits -> 32; the padding adds exact zeros),
    each block at a multiple of 4 floats (the kernels copy them 16 bytes
    at a time); returns the skinning fields of `NetMeta` (the true
    widths)."""
    wt, bo = [], []
    for w, b in zip(skin_weights, skin_biases):
        pad = -w.shape[0] % 32
        wt.append(pack.put(torch.nn.functional.pad(w.detach().T, (0, pad)),
                           align=4))
        bo.append(pack.put(torch.nn.functional.pad(b.detach(), (0, pad)),
                           align=4))
    dims = [skin_weights[0].shape[1]] + [w.shape[0] for w in skin_weights]
    sk = _build.ctypes.c_longlong * 8
    zeros = [0] * (8 - len(skin_weights))
    return dict(n_skin=len(skin_weights),
                skin_dims=(_build._I * 9)(*(dims + [0] * (9 - len(dims)))),
                skin_wt_off=sk(*(wt + zeros)), skin_b_off=sk(*(bo + zeros)))


def check_skin_dims(skin_weights, name: str):
    """Raise ValueError on a collapsed skinning MLP (dense (out, in)
    weights) that the kernels' packs do not take: widths 3, ..., 25, at
    most 8 layers, none wider than 256."""
    dims = [skin_weights[0].shape[1]] + [w.shape[0] for w in skin_weights]
    if dims[0] != 3 or dims[-1] != 25 or len(skin_weights) > 8 \
            or max(dims[1:]) > 256:
        raise ValueError(f'{name}: unsupported skinning MLP {dims}')


def pack_trace(gen: GeneratedMLP, skin_weights=None,
               skin_biases=None) -> TracePack:
    """One buffer for kernels E and F, and for B, whose pack is its
    skinning blocks (`ops/corr.py:pack_corr`): the generated SIREN
    (`pack_siren`) and, when given, the collapsed skinning MLP
    (`put_skin_padded`; widths 3, ..., 25). Every block starts at a
    multiple of 4 floats (16-byte copies into the kernels' shared-memory
    ring). Raises on a shape the kernels do not take."""
    pack = _build.ParamPack()
    fields = pack_siren(gen, pack, align=4)
    if skin_weights is not None:
        check_skin_dims(skin_weights, 'iso kernel')
        fields.update(put_skin_padded(pack, skin_weights, skin_biases))
    return TracePack(pack.tensor(), _build.NetMeta(**fields))


def pass_widths(meta: _build.NetMeta, skin: bool, siren: bool) -> list:
    """The layer widths of the network pass of `meta` (its SIREN's hidden
    width if `siren`, 0 without one; then its skinning MLP's widths padded
    to 32 if `skin`), as csrc/stream_mlp.cuh:pass_widest reads them."""
    hidden = meta.hidden if siren and meta.n_layers > 1 else 0
    return [hidden] + ([-(-meta.skin_dims[l + 1] // 32) * 32
                        for l in range(meta.n_skin)] if skin else [])


def check_pass(kernel: str, meta: _build.NetMeta, shapes, shape: int,
               skin: bool, siren: bool):
    """Raise ValueError unless launch shape `shape` of `shapes` ((cluster
    size, widest layer) each) takes the network pass of `meta` (its
    skinning MLP if `skin`, its SIREN's hidden layers if `siren`): the
    check of csrc/stream_mlp.cuh:launch_tile. The pass's widest layer
    (skinning widths padded to 32) must fit the shape, and a SIREN's
    width must split into whole warps over the cluster's CTAs."""
    if not 0 <= shape < len(shapes):
        raise ValueError(f'{kernel} kernel: no launch shape {shape}')
    cluster, maxw = shapes[shape]
    widths = pass_widths(meta, skin, siren)
    if max(widths) > maxw or widths[0] % (32 * cluster):
        raise ValueError(
            f'{kernel} kernel: launch shape {shape} takes layers at most '
            f'{maxw} wide and a SIREN width that is a multiple of '
            f'{32 * cluster}; got widths {widths}')


def launch_shape(n: int) -> int:
    """The launch shape of kernel E or F for n rays: 0 for phase 1's
    thousands of rays, 1 for a phase-2 batch of at most a couple of
    thousand. E's are 64-ray CTAs (one an SM, every ray of a frame
    resident at once), then 16-ray clusters of 4 CTAs; F's are 16-ray
    clusters of 4, then of 8 (csrc/march.cu, csrc/iso.cu; chosen by a
    sweep on the H100, PERF.md). A cluster of C CTAs takes a SIREN of
    width a multiple of 32 C, at most 256: the launch raises otherwise."""
    return 0 if n > 2048 else 1


def tile_shape(kernel: str, shape: int, n: int) -> dict:
    """The launch of kernel 'march', 'iso', 'corr' (B and L) or 'siren'
    (J) at shape `shape` for n rays (points): blocks, cluster size, rays a
    CTA, dynamic shared memory a CTA and CTAs resident an SM (the card's
    occupancy query; nothing launched)."""
    out = (_build.ctypes.c_int * 5)()
    fn = {'march': 'arah_march_shape', 'iso': 'arah_iso_shape',
          'corr': 'arah_corr_shape', 'siren': 'arah_siren_shape'}[kernel]
    _build.check(getattr(_build.load(), fn)(shape, n, out), kernel)
    return dict(zip(('blocks', 'cluster', 'rays', 'smem', 'per_sm'), out))


def launch_march(cam, dirs, near, far, verts, skin_weights,
                 frame: CanonicalFrame, packed: TracePack, n_iters: int,
                 thresh: float, clamp_dist: float, shape: int,
                 iters: torch.Tensor | None = None):
    """Launch kernel E at launch shape `shape` (0 or 1, `launch_shape`)
    on checked operands; writes each ray's iteration count into `iters`
    ((N,) int32) when given. Returns (t, unfinished, diverged, x_norm,
    T16, counters): counters[1] counts the nearest-vertex ties the kernel
    re-scanned."""
    n, nv = dirs.shape[0], verts.shape[0]
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    fvec = frame_vec(frame)
    dev = dirs.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    unf = torch.empty((n,), dtype=torch.bool, device=dev)
    div = torch.empty((n,), dtype=torch.bool, device=dev)
    x_norm = torch.empty((n, 3), dtype=torch.float32, device=dev)
    T16 = torch.empty((n, 16), dtype=torch.float32, device=dev)
    verts4 = torch.empty((nv, 4), dtype=torch.float32, device=dev)
    counters = torch.empty((2,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.arah_march(
        cam.data_ptr(), dirs.data_ptr(), near.data_ptr(), far.data_ptr(), n,
        verts.data_ptr(), nv, skin_weights.data_ptr(), bones16.data_ptr(),
        fvec.data_ptr(), packed.params.data_ptr(), packed.meta, int(n_iters),
        float(thresh), float(clamp_dist), int(shape), verts4.data_ptr(),
        counters.data_ptr(), t.data_ptr(), unf.data_ptr(), div.data_ptr(),
        x_norm.data_ptr(), T16.data_ptr(),
        0 if iters is None else iters.data_ptr(),
        _build.stream_ptr(dirs)), 'march')
    trace.COUNTS['march'] += 1
    return t, unf, div, x_norm, T16, counters


def sphere_march(cam, dirs, near, far, verts, skin_weights,
                 frame: CanonicalFrame, gen: GeneratedMLP,
                 n_iters: int = 50, thresh: float = 1e-5,
                 clamp_dist: float = 0.1, packed: TracePack | None = None):
    """Kernel E. cam/dirs (N, 3) per-ray origins and directions; near/far
    (N,); verts (V, 3) posed vertices (world); skin_weights (V, 24); the
    frame's bones, trans and canonical box; the generated SIREN (`packed`:
    its `pack_trace`, made once where both phases and kernel F share it).
    Returns (t (N,), unfinished (N,) bool, diverged (N,) bool, x_norm
    (N, 3), T16 (N, 16))."""
    if not dirs.is_cuda:
        return sphere_march_plain(cam, dirs, near, far, verts, skin_weights,
                                  frame, gen, n_iters, thresh,
                                  clamp_dist)[:5]
    n, nv = dirs.shape[0], verts.shape[0]
    for a, name, shape in ((cam, 'cam', (n, 3)), (dirs, 'dirs', (n, 3)),
                           (near, 'near', (n,)), (far, 'far', (n,)),
                           (verts, 'verts', (nv, 3)),
                           (skin_weights, 'skin_weights', (nv, 24))):
        _build.require(a, name, torch.float32, shape)
    if packed is None:
        packed = pack_trace(gen)
    return launch_march(cam, dirs, near, far, verts, skin_weights, frame,
                        packed, n_iters, thresh, clamp_dist,
                        launch_shape(n))[:5]
