"""Joint (canonical point, depth) iso-surface refinement: kernel F and its
plain version.

`iso_refine` launches the CUDA kernel (csrc/iso.cu, the port of
`arah_tpu/ops/pallas/iso_kernel.py:iso_refine_pallas`) for CUDA tensors
and computes `iso_refine_plain` for CPU tensors: the Broyden of
`solver/broyden.py` on the kernel's residual g(u) = [sdf(x_hat);
fwd_skin(x_hat) - (cam + z dir - trans)] over u = (x_hat, z), with the
collapsed skinning MLP (`ops/corr.py:dense_skin_fn`), the generated SIREN
and the kernel's normalisation, started from a given inverse Jacobian
(computed outside, as in JAX: `iso_kernel.py:13-15`).
"""
from __future__ import annotations

import torch

from arah_tpu_torch.nn.siren import GeneratedMLP, siren_apply
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.corr import dense_skin_fn
from arah_tpu_torch.core.body import skinning
from arah_tpu_torch.ops.march import (TracePack, frame_vec, kernel_affine,
                                      launch_shape, pack_trace)
from arah_tpu_torch.solver.broyden import broyden
from arah_tpu_torch.solver.root_find import CanonicalFrame
from arah_tpu_torch.utils import trace


def iso_residual(cam, dirs, skin_weights, skin_biases, frame: CanonicalFrame,
                 gen: GeneratedMLP, softmax_scale: float = 20.0):
    """The kernel's residual as a function of u (N, 4): u -> (g (N, 4) =
    [metric sdf, fwd_skin(x_hat) - (cam + z dir - trans)], T16 (N, 16))."""
    nscale, noffset, mscale = kernel_affine(frame)
    skin = dense_skin_fn(skin_weights, skin_biases, softmax_scale)

    def g(u):
        x, z = u[:, :3], u[:, 3:4]
        xn = x * nscale + noffset
        xb, T = skinning(x, skin(xn), frame.bone_transforms)
        err = xb - ((cam + z * dirs) - frame.trans)
        sdf = siren_apply(gen, xn)[:, 0] * mscale
        return torch.cat([sdf[:, None], err], dim=-1), T.reshape(-1, 16)
    return g


@torch.no_grad()
def iso_refine_plain(cam, dirs, u0, T0_16, J_inv0_16, mask, skin_weights,
                     skin_biases, frame: CanonicalFrame, gen: GeneratedMLP,
                     max_steps: int = 50, cvg_thresh: float = 1e-5,
                     softmax_scale: float = 20.0):
    """Plain version of kernel F. Returns (u (N, 4), T16 (N, 16), valid
    (N,), active (N,), iters (N,) int32: the Broyden iterations each ray
    ran). Masked rays keep u0 and T0."""
    n = dirs.shape[0]
    g = iso_residual(cam, dirs, skin_weights, skin_biases, frame, gen,
                     softmax_scale)
    res = broyden(g, u0, T0_16, J_inv0_16.reshape(n, 4, 4),
                  max_steps=max_steps, cvg_thresh=cvg_thresh,
                  active_init=mask)
    return res.x, res.aux, res.valid, res.active, res.iters


def launch_iso(cam, dirs, u0, T0_16, J_inv0_16, mask, frame: CanonicalFrame,
               packed: TracePack, max_steps: int, cvg_thresh: float,
               softmax_scale: float, shape: int,
               iters: torch.Tensor | None = None):
    """Launch kernel F at launch shape `shape` (0 or 1, `launch_shape`)
    on checked operands; writes each ray's Broyden iteration count into
    `iters` ((N,) int32) when given. Returns (u, T16, valid, active)."""
    n = dirs.shape[0]
    if packed.meta.n_skin == 0:
        raise ValueError('iso kernel: the pack holds no skinning MLP')
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    fvec = frame_vec(frame)
    dev = dirs.device
    u = torch.empty((n, 4), dtype=torch.float32, device=dev)
    T16 = torch.empty((n, 16), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    active = torch.empty((n,), dtype=torch.bool, device=dev)
    counters = torch.empty((2,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.arah_iso(
        cam.data_ptr(), dirs.data_ptr(), u0.data_ptr(), T0_16.data_ptr(),
        J_inv0_16.data_ptr(), mask.data_ptr(), n, bones16.data_ptr(),
        fvec.data_ptr(), packed.params.data_ptr(), packed.meta,
        int(max_steps), float(cvg_thresh), 1.0, 1e-6, float(softmax_scale),
        int(shape), counters.data_ptr(), u.data_ptr(), T16.data_ptr(),
        valid.data_ptr(), active.data_ptr(),
        0 if iters is None else iters.data_ptr(),
        _build.stream_ptr(dirs)), 'iso')
    trace.COUNTS['iso'] += 1
    return u, T16, valid, active


def iso_refine(cam, dirs, u0, T0_16, J_inv0_16, mask, skin_weights,
               skin_biases, frame: CanonicalFrame, gen: GeneratedMLP,
               max_steps: int = 50, cvg_thresh: float = 1e-5,
               softmax_scale: float = 20.0, packed: TracePack | None = None):
    """Kernel F. cam/dirs (N, 3); u0 (N, 4) [x_hat (metric), z]; T0_16
    (N, 16) initial transforms; J_inv0_16 (N, 16) initial inverse
    Jacobian (row-major 4x4); mask (N,) rays to solve; dense (out, in)
    skinning weights and (out,) biases; the frame; the generated SIREN
    (`packed`: `pack_trace(gen, skin_weights, skin_biases)`, made once
    where both phases and kernel E share it). Returns (u (N, 4), T16
    (N, 16), valid (N,), active (N,))."""
    if not dirs.is_cuda:
        return iso_refine_plain(cam, dirs, u0, T0_16, J_inv0_16, mask,
                                skin_weights, skin_biases, frame, gen,
                                max_steps, cvg_thresh, softmax_scale)[:4]
    n = dirs.shape[0]
    for a, name, shape, dt in (
            (cam, 'cam', (n, 3), torch.float32),
            (dirs, 'dirs', (n, 3), torch.float32),
            (u0, 'u0', (n, 4), torch.float32),
            (T0_16, 'T0_16', (n, 16), torch.float32),
            (J_inv0_16, 'J_inv0_16', (n, 16), torch.float32),
            (mask, 'mask', (n,), torch.bool)):
        _build.require(a, name, dt, shape)
    if packed is None:
        packed = pack_trace(gen, skin_weights, skin_biases)
    return launch_iso(cam, dirs, u0, T0_16, J_inv0_16, mask, frame, packed,
                      max_steps, cvg_thresh, softmax_scale,
                      launch_shape(n))
