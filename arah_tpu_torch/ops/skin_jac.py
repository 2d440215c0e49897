"""Exact forward-skinning Jacobian: kernel G and its plain version.

`skinning_jac` launches the CUDA kernel (csrc/skin_jac.cu, the port of
`arah_tpu/ops/pallas/corr_kernel_t.py:skinning_jac_pallas`) for CUDA
tensors and computes `skinning_jac_plain` for CPU tensors: d fwd_skin /
d x_hat at (N, 3) metric canonical points, through the collapsed skinning
MLP (`ops/corr.py:dense_skin_fn`) at the kernels' normalisation, the bone
blend and LBS, as one primal pass and three forward-mode tangents (the
JAX linearize path, `arah_tpu/render/renderer.py:318-321`). Returns
(N, 3, 3) with [i, k] = d xb_i / d x_k. Nothing differentiates through it.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.core.body import skinning
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.corr import dense_skin_fn
from arah_tpu_torch.ops.march import frame_vec, kernel_affine, put_skin_padded
from arah_tpu_torch.solver.root_find import CanonicalFrame
from arah_tpu_torch.utils import trace


@torch.no_grad()
def skinning_jac_plain(x_hat, skin_weights, skin_biases,
                       frame: CanonicalFrame, softmax_scale: float = 20.0,
                       precision: str = 'f32'):
    """Plain version of kernel G: three `torch.func.jvp` tangents; with a
    `precision` other than 'f32', the Jacobian that kernel B's `want_jac`
    gives, through B's rounded products (`ops/corr.py:dense_skin_fn`)."""
    nscale, noffset, _ = kernel_affine(frame)
    skin = dense_skin_fn(skin_weights, skin_biases, softmax_scale, precision)

    def fwd(x):
        return skinning(x, skin(x * nscale + noffset),
                        frame.bone_transforms)[0]

    cols = []
    for k in range(3):
        tk = torch.zeros_like(x_hat)
        tk[:, k] = 1.0
        cols.append(torch.func.jvp(fwd, (x_hat,), (tk,))[1])
    return torch.stack(cols, dim=-1)


def pack_skin_jac(skin_weights, skin_biases):
    """Kernel G's operands: (f32 buffer, NetMeta) in the layout of
    `ops/march.py:put_skin_padded`."""
    pack = _build.ParamPack()
    meta = _build.NetMeta(**put_skin_padded(pack, skin_weights, skin_biases))
    return pack.tensor(), meta


def skinning_jac(x_hat, skin_weights, skin_biases, frame: CanonicalFrame,
                 softmax_scale: float = 20.0):
    """Kernel G. x_hat (N, 3) metric canonical points; dense (out, in)
    skinning weights and (out,) biases; the frame's bones and canonical
    box. Returns J (N, 3, 3)."""
    x_hat = x_hat.detach()
    if not x_hat.is_cuda:
        return skinning_jac_plain(x_hat, skin_weights, skin_biases, frame,
                                  softmax_scale)
    n = x_hat.shape[0]
    dims = [skin_weights[0].shape[1]] + [w.shape[0] for w in skin_weights]
    if dims[0] != 3 or dims[-1] != 25 or len(skin_weights) > 8 \
            or max(dims[1:]) > 128:
        raise ValueError(f'skin_jac kernel: unsupported skinning MLP {dims}'
                         ' (3 -> hidden widths of at most 128 -> 25)')
    x_hat = x_hat.contiguous()
    _build.require(x_hat, 'x_hat', torch.float32, (n, 3))
    params, meta = pack_skin_jac(skin_weights, skin_biases)
    bones16 = frame.bone_transforms.detach().reshape(24, 16).contiguous()
    fvec = frame_vec(frame)
    jac = torch.empty((n, 3, 3), dtype=torch.float32, device=x_hat.device)
    lib = _build.load()
    _build.check(lib.arah_skin_jac(
        x_hat.data_ptr(), n, bones16.data_ptr(), fvec.data_ptr(),
        params.data_ptr(), meta, float(softmax_scale), jac.data_ptr(),
        _build.stream_ptr(x_hat)), 'skin_jac')
    trace.COUNTS['skin_jac'] += 1
    return jac
