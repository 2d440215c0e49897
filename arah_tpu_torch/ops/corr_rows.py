"""Canonical-correspondence Broyden search in the row layout: kernel L and
its plain version.

`corr_search_rows` launches the CUDA kernel (csrc/corr_rows.cu, the port
of `arah_tpu/ops/pallas/corr_kernel.py:corr_search_pallas`) for CUDA
tensors and computes `corr_search_rows_plain` —
`solver.root_find.search_canonical_corr` on the same collapsed skinning
MLP — for CPU tensors. The semantics of kernel B (`ops/corr.py`) with
the Pallas kernel's interface: pre-transposed (in, out) weights, masked
points returning x0 and T0, and no `active` output.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.corr import corr_search_plain


def corr_search_rows_plain(x_bar, x0, T0_16, mask, skin_weights_t,
                           skin_biases, bones16, coord_min, coord_max,
                           center, max_steps: int = 50,
                           cvg_thresh: float = 1e-5,
                           softmax_scale: float = 20.0):
    """Plain version of kernel L; returns (x_hat (N, 3), T16 (N, 16),
    valid (N,))."""
    return corr_search_plain(
        x_bar, x0, T0_16, mask, [w.T for w in skin_weights_t], skin_biases,
        bones16, coord_min, coord_max, center, max_steps, cvg_thresh,
        softmax_scale)[:3]


def corr_search_rows(x_bar, x0, T0_16, mask, skin_weights_t, skin_biases,
                     bones16, coord_min, coord_max, center,
                     max_steps: int = 50, cvg_thresh: float = 1e-5,
                     softmax_scale: float = 20.0):
    """Kernel L. x_bar/x0 (N, 3) metric canonical targets and inits;
    T0_16 (N, 16) initial blended transforms; mask (N,) bool; the
    skinning MLP's (in, out) weights and (out,) biases; bones16 (24, 16);
    coord_min/coord_max () and center (3,). Returns (x_hat, T16,
    valid)."""
    if not x_bar.is_cuda:
        return corr_search_rows_plain(x_bar, x0, T0_16, mask, skin_weights_t,
                                      skin_biases, bones16, coord_min,
                                      coord_max, center, max_steps,
                                      cvg_thresh, softmax_scale)
    n = x_bar.shape[0]
    dims = [skin_weights_t[0].shape[0]] + [w.shape[1] for w in
                                           skin_weights_t]
    if dims[0] != 3 or dims[-1] != 25 or len(skin_weights_t) > 8 \
            or max(dims[1:]) > 256:
        raise ValueError(f'corr_rows kernel: unsupported skinning MLP {dims}')
    for a, name, shape, dt in (
            (x_bar, 'x_bar', (n, 3), torch.float32),
            (x0, 'x0', (n, 3), torch.float32),
            (T0_16, 'T0_16', (n, 16), torch.float32),
            (mask, 'mask', (n,), torch.bool),
            (bones16, 'bones16', (24, 16), torch.float32)):
        _build.require(a, name, dt, shape)
    pack = _build.ParamPack()
    sk = _build.ctypes.c_longlong * 8
    pad = [0] * (8 - len(skin_weights_t))
    meta = _build.NetMeta(
        n_skin=len(skin_weights_t),
        skin_dims=(_build._I * 9)(*(dims + [0] * (9 - len(dims)))),
        skin_wt_off=sk(*([pack.put(w) for w in skin_weights_t] + pad)),
        skin_b_off=sk(*([pack.put(b) for b in skin_biases] + pad)))
    params = pack.tensor()
    frame = torch.cat([coord_min.reshape(1), coord_max.reshape(1),
                       center.reshape(3), center.new_zeros(3)]).float() \
        .contiguous()
    dev = x_bar.device
    x_hat = torch.empty((n, 3), dtype=torch.float32, device=dev)
    T16 = torch.empty((n, 16), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = _build.load()
    _build.check(lib.arah_corr_rows(
        x_bar.data_ptr(), x0.data_ptr(), T0_16.data_ptr(), mask.data_ptr(),
        n, bones16.data_ptr(), frame.data_ptr(), params.data_ptr(), meta,
        int(max_steps), float(cvg_thresh), 1.0, 1e-6, float(softmax_scale),
        x_hat.data_ptr(), T16.data_ptr(), valid.data_ptr(),
        _build.stream_ptr(x_bar)), 'corr_rows')
    _build.COUNTS['corr_rows'] += 1
    return x_hat, T16, valid
