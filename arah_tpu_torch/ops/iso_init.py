"""The inverse of the iso Broyden's joint init Jacobian: kernel iso_init
and its plain version.

`iso_init` launches the CUDA kernel (csrc/iso_init.cu) for CUDA tensors
and computes `iso_init_plain` for CPU tensors: per ray, the inverse of
[[grad_sdf, 0], [J_lbs, -dir]] (row-major, (N, 16)), the J_inv0 that
kernel F starts from. grad_sdf is the generated SIREN's f32 input
gradient (`ops/shade.py:siren_shade_plain`) at the kernels' normalisation
(`ops/march.py:kernel_affine`), scaled to metric; J_lbs is the exact
forward-skinning Jacobian through the collapsed skinning MLP
(`ops/skin_jac.py:skinning_jac_plain`, kernel G's plain version); the
inverse is `core/linalg.py:inv4x4`. It is the init that
`solver/root_find.py:iso_init_inv_jacobian` computes with forward-mode
tangents of the uncollapsed networks, up to rounding. The JAX package has
no Pallas kernel for it (its init runs under XLA).

The kernel reads the trace's one parameter pack (`ops/march.py:
pack_trace` with the skinning MLP), which kernels E, F and B read;
`launch_shape` picks its tile from the number of rays.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.core.linalg import inv4x4
from arah_tpu_torch.nn.siren import GeneratedMLP
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.march import (TracePack, frame_vec, kernel_affine,
                                      pack_trace)
from arah_tpu_torch.ops.shade import siren_shade_plain
from arah_tpu_torch.ops.skin_jac import skinning_jac_plain
from arah_tpu_torch.solver.root_find import CanonicalFrame
from arah_tpu_torch.utils import trace

# rays a block of csrc/iso_init.cu's launch shapes
SHAPES = (16, 8)


@torch.no_grad()
def iso_init_plain(x_hat, dirs, skin_weights, skin_biases,
                   frame: CanonicalFrame, gen: GeneratedMLP,
                   softmax_scale: float = 20.0) -> torch.Tensor:
    """Plain version of the kernel: x_hat (N, 3) metric canonical points,
    dirs (N, 3) ray directions -> J_inv0 (N, 16)."""
    nscale, noffset, mscale = kernel_affine(frame)
    grad = siren_shade_plain(gen, x_hat * nscale + noffset)[2] \
        * nscale * mscale
    J = skinning_jac_plain(x_hat, skin_weights, skin_biases, frame,
                           softmax_scale)
    n = x_hat.shape[0]
    top = torch.cat([grad[:, None, :], grad.new_zeros((n, 1, 1))], dim=-1)
    bottom = torch.cat([J, -dirs[..., None]], dim=-1)
    return inv4x4(torch.cat([top, bottom], dim=-2)).reshape(n, 16)


def check_iso_init(gen: GeneratedMLP, skin_weights):
    """Raise ValueError on networks the kernel does not take: a SIREN
    3 -> H x (L-1) -> out (2 <= L <= 8, H a multiple of 4 of at most 256,
    as kernels E and F take it) and a collapsed skinning MLP 3 -> ... -> 25
    of at most 8 layers with hidden widths of at most 128 (kernel G's
    limits)."""
    dims = [skin_weights[0].shape[1]] + [w.shape[0] for w in skin_weights]
    if dims[0] != 3 or dims[-1] != 25 or len(skin_weights) > 8 \
            or max(dims[1:-1], default=0) > 128:
        raise ValueError(f'iso_init kernel: unsupported skinning MLP {dims}'
                         ' (3 -> hidden widths of at most 128 -> 25)')
    shapes = [tuple(w.shape) for w in gen.weights]
    L, H = len(shapes), shapes[0][0]
    if (not 2 <= L <= 8 or shapes[0][1] != 3 or H % 4 or H > 256
            or any(s != (H, H) for s in shapes[1:-1])
            or shapes[-1][1] != H):
        raise ValueError(f'iso_init kernel: unsupported SIREN shape {shapes}')


def launch_shape(n: int) -> int:
    """The launch shape for n rays: 0 (16 rays a block) for phase 1's
    thousands, 1 (8 rays a block, twice the blocks) for a phase-2 batch of
    at most a couple of thousand, which fills few of the card's SMs."""
    return 0 if n > 2048 else 1


def init_shape(shape: int, n: int, packed: TracePack) -> dict:
    """Launch shape `shape` for n rays of the networks of `packed`:
    blocks, rays a block, dynamic shared memory a block and blocks
    resident an SM (the card's occupancy query; nothing launched)."""
    out = (_build.ctypes.c_int * 4)()
    _build.check(_build.load().arah_iso_init_shape(shape, n, packed.meta,
                                                   out), 'iso_init')
    return dict(zip(('blocks', 'rays', 'smem', 'per_sm'), out))


def launch_iso_init(x_hat, dirs, frame: CanonicalFrame, packed: TracePack,
                    softmax_scale: float, shape: int) -> torch.Tensor:
    """Launch the kernel at launch shape `shape` (`SHAPES`) on checked
    operands with the trace's pack. Returns J_inv0 (N, 16)."""
    if packed.meta.n_skin == 0:
        raise ValueError('iso_init kernel: the pack holds no skinning MLP')
    n = dirs.shape[0]
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    fvec = frame_vec(frame)
    out = torch.empty((n, 16), dtype=torch.float32, device=dirs.device)
    lib = _build.load()
    _build.check(lib.arah_iso_init(
        x_hat.data_ptr(), dirs.data_ptr(), n, bones16.data_ptr(),
        fvec.data_ptr(), packed.params.data_ptr(), packed.meta,
        float(softmax_scale), int(shape), out.data_ptr(),
        _build.stream_ptr(dirs)), 'iso_init')
    trace.COUNTS['iso_init'] += 1
    return out


def iso_init(x_hat, dirs, skin_weights, skin_biases, frame: CanonicalFrame,
             gen: GeneratedMLP, softmax_scale: float = 20.0,
             packed: TracePack | None = None) -> torch.Tensor:
    """Kernel iso_init. x_hat (N, 3) metric canonical points (the march's),
    dirs (N, 3) ray directions; dense (out, in) skinning weights and (out,)
    biases; the frame's bones and canonical box; the generated SIREN
    (`packed`: `pack_trace(gen, skin_weights, skin_biases)`, the trace's
    pack, made here when not given). Returns J_inv0 (N, 16), row-major."""
    if not dirs.is_cuda:
        return iso_init_plain(x_hat, dirs, skin_weights, skin_biases, frame,
                              gen, softmax_scale)
    check_iso_init(gen, skin_weights)
    n = dirs.shape[0]
    _build.require(x_hat, 'x_hat', torch.float32, (n, 3))
    _build.require(dirs, 'dirs', torch.float32, (n, 3))
    if packed is None:
        packed = pack_trace(gen, skin_weights, skin_biases)
    return launch_iso_init(x_hat, dirs, frame, packed, softmax_scale,
                           launch_shape(n))
