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
from arah_tpu_torch.ops.march import frame_vec, kernel_affine
from arah_tpu_torch.solver.root_find import CanonicalFrame


@torch.no_grad()
def skinning_jac_plain(x_hat, skin_weights, skin_biases,
                       frame: CanonicalFrame, softmax_scale: float = 20.0):
    """Plain version of kernel G: three `torch.func.jvp` tangents."""
    nscale, noffset, _ = kernel_affine(frame)
    skin = dense_skin_fn(skin_weights, skin_biases, softmax_scale)

    def fwd(x):
        return skinning(x, skin(x * nscale + noffset),
                        frame.bone_transforms)[0]

    cols = []
    for k in range(3):
        tk = torch.zeros_like(x_hat)
        tk[:, k] = 1.0
        cols.append(torch.func.jvp(fwd, (x_hat,), (tk,))[1])
    return torch.stack(cols, dim=-1)


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
            or max(dims[1:]) > 256:
        raise ValueError(f'skin_jac kernel: unsupported skinning MLP {dims}')
    x_hat = x_hat.contiguous()
    _build.require(x_hat, 'x_hat', torch.float32, (n, 3))
    pack = _build.ParamPack()
    sk = _build.ctypes.c_longlong * 8
    pad = [0] * (8 - len(skin_weights))
    skin_wt = [pack.put(w.detach().T.contiguous()) for w in skin_weights]
    skin_b = [pack.put(b.detach()) for b in skin_biases]
    meta = _build.NetMeta(
        n_skin=len(skin_weights),
        skin_dims=(_build._I * 9)(*(dims + [0] * (9 - len(dims)))),
        skin_wt_off=sk(*(skin_wt + pad)), skin_b_off=sk(*(skin_b + pad)))
    params = pack.tensor()
    bones16 = frame.bone_transforms.detach().reshape(24, 16).contiguous()
    fvec = frame_vec(frame)
    jac = torch.empty((n, 3, 3), dtype=torch.float32, device=x_hat.device)
    lib = _build.load()
    _build.check(lib.arah_skin_jac(
        x_hat.data_ptr(), n, bones16.data_ptr(), fvec.data_ptr(),
        params.data_ptr(), meta, float(softmax_scale), jac.data_ptr(),
        _build.stream_ptr(x_hat)), 'skin_jac')
    _build.COUNTS['skin_jac'] += 1
    return jac
