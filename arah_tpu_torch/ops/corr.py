"""Canonical-correspondence Broyden search: kernel B and its plain version.

`corr_search` launches the CUDA kernel (csrc/corr_rows.cu, the port of
`arah_tpu/ops/pallas/corr_kernel_t.py:corr_search_pallas_t`; one body with
kernel L, `ops/corr_rows.py`) for CUDA tensors and computes
`corr_search_plain` — `solver.root_find.search_canonical_corr` on the same
collapsed skinning MLP — for CPU tensors. Same semantics: per-point
Broyden with best-iterate tracking, masked points frozen at their init,
and the `active` output.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.core.body import hierarchical_softmax
from arah_tpu_torch.nn.layers import softplus100
from arah_tpu_torch.ops import _build
from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                             search_canonical_corr)


def dense_skin_fn(skin_weights, skin_biases, softmax_scale: float):
    """Normalized points (N, 3) -> (N, 24) weights of a collapsed
    skinning MLP (softplus100 hidden layers, hierarchical softmax)."""
    def skin_fn(x):
        h = x
        for w, b in zip(skin_weights[:-1], skin_biases[:-1]):
            h = softplus100(h @ w.T + b)
        logits = h @ skin_weights[-1].T + skin_biases[-1]
        return hierarchical_softmax(logits * softmax_scale)
    return skin_fn


def corr_search_plain(x_bar, x0, T0_16, mask, skin_weights, skin_biases,
                      bones16, coord_min, coord_max, center,
                      max_steps: int = 50, cvg_thresh: float = 1e-5,
                      softmax_scale: float = 20.0):
    """Plain version of kernel B; returns (x_hat (N, 3), T16 (N, 16),
    valid (N,), active (N,))."""
    n = x_bar.shape[0]
    frame = CanonicalFrame(bones16.reshape(24, 4, 4),
                           torch.zeros(3, device=x_bar.device),
                           coord_min, coord_max, center)
    res = search_canonical_corr(
        dense_skin_fn(skin_weights, skin_biases, softmax_scale), frame,
        x_bar, x0, T0_16.reshape(n, 4, 4), max_steps=max_steps,
        cvg_thresh=cvg_thresh, active_init=mask)
    return res.x_hat, res.T_fwd.reshape(n, 16), res.valid & mask, res.active


def pack_skin_t(skin_weights_t, skin_biases):
    """(parameter buffer, NetMeta) of the collapsed skinning MLP for the
    corr kernel (B and L): (in, out) weights, (out,) biases. Raises on a
    shape the kernel does not take."""
    dims = [skin_weights_t[0].shape[0]] + [w.shape[1] for w in
                                           skin_weights_t]
    if dims[0] != 3 or dims[-1] != 25 or len(skin_weights_t) > 8 \
            or max(dims[1:]) > 256:
        raise ValueError(f'corr kernel: unsupported skinning MLP {dims}')
    pack = _build.ParamPack()
    sk = _build.ctypes.c_longlong * 8
    pad = [0] * (8 - len(skin_weights_t))
    meta = _build.NetMeta(
        n_skin=len(skin_weights_t),
        skin_dims=(_build._I * 9)(*(dims + [0] * (9 - len(dims)))),
        skin_wt_off=sk(*([pack.put(w) for w in skin_weights_t] + pad)),
        skin_b_off=sk(*([pack.put(b) for b in skin_biases] + pad)))
    return pack.tensor(), meta


def launch_corr(count: str, x_bar, x0, T0_16, mask, pack, bones16,
                coord_min, coord_max, center, max_steps: int,
                cvg_thresh: float, softmax_scale: float, want_active: bool):
    """One launch of the corr kernel on CUDA tensors with the skinning MLP's
    `pack` (`pack_skin_t`), counted under `COUNTS[count]`. Returns (x_hat,
    T16, valid, active or None)."""
    n = x_bar.shape[0]
    for a, name, shape, dt in (
            (x_bar, 'x_bar', (n, 3), torch.float32),
            (x0, 'x0', (n, 3), torch.float32),
            (T0_16, 'T0_16', (n, 16), torch.float32),
            (mask, 'mask', (n,), torch.bool),
            (bones16, 'bones16', (24, 16), torch.float32)):
        _build.require(a, name, dt, shape)
    params, meta = pack
    frame = torch.cat([coord_min.reshape(1), coord_max.reshape(1),
                       center.reshape(3), center.new_zeros(3)]).float() \
        .contiguous()
    dev = x_bar.device
    x_hat = torch.empty((n, 3), dtype=torch.float32, device=dev)
    T16 = torch.empty((n, 16), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    active = torch.empty((n,), dtype=torch.bool, device=dev) \
        if want_active else None
    lib = _build.load()
    _build.check(lib.arah_corr(
        x_bar.data_ptr(), x0.data_ptr(), T0_16.data_ptr(), mask.data_ptr(),
        n, bones16.data_ptr(), frame.data_ptr(), params.data_ptr(), meta,
        int(max_steps), float(cvg_thresh), 1.0, 1e-6, float(softmax_scale),
        x_hat.data_ptr(), T16.data_ptr(), valid.data_ptr(),
        None if active is None else active.data_ptr(),
        _build.stream_ptr(x_bar)), count)
    _build.COUNTS[count] += 1
    return x_hat, T16, valid, active


def corr_search(x_bar, x0, T0_16, mask, skin_weights, skin_biases, bones16,
                coord_min, coord_max, center, max_steps: int = 50,
                cvg_thresh: float = 1e-5, softmax_scale: float = 20.0,
                precision: str = 'f32', want_jac: bool = False):
    """Kernel B. x_bar/x0 (N, 3) metric canonical targets and inits;
    T0_16 (N, 16) initial blended transforms; mask (N,) bool; dense (out,
    in) skinning weights and (out,) biases; bones16 (24, 16); coord_min/
    coord_max () and center (3,). Returns (x_hat, T16, valid, active)."""
    if want_jac:
        raise NotImplementedError(
            'corr_search(want_jac=True) is a training option, not ported yet')
    if not x_bar.is_cuda:
        return corr_search_plain(x_bar, x0, T0_16, mask, skin_weights,
                                 skin_biases, bones16, coord_min, coord_max,
                                 center, max_steps, cvg_thresh,
                                 softmax_scale)
    if precision != 'f32':
        raise NotImplementedError(
            f"corr kernel precision={precision!r}: only 'f32' is ported")
    # the (in, out) views are copied, transposed, into the pack
    return launch_corr('corr', x_bar, x0, T0_16, mask,
                       pack_skin_t([w.t() for w in skin_weights],
                                   skin_biases), bones16,
                       coord_min, coord_max, center, max_steps, cvg_thresh,
                       softmax_scale, want_active=True)
