"""Canonical-correspondence Broyden search in the row layout: kernel L and
its plain version.

`corr_search_rows` launches the CUDA kernel (csrc/corr_rows.cu, the port
of `arah_tpu/ops/pallas/corr_kernel.py:corr_search_pallas`; one body with
kernel B, `ops/corr.py`, which describes its design) for CUDA tensors and
computes `corr_search_rows_plain` — `solver.root_find.search_canonical_corr`
on the same collapsed skinning MLP — for CPU tensors. The semantics of
kernel B with the Pallas kernel's interface: pre-transposed (in, out)
weights, masked points returning x0 and T0, and no `active` output.
"""
from __future__ import annotations

from arah_tpu_torch.ops.corr import (corr_search_plain, launch_corr,
                                     pack_corr)
from arah_tpu_torch.ops.march import TracePack


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
                     softmax_scale: float = 20.0,
                     packed: TracePack | None = None):
    """Kernel L. x_bar/x0 (N, 3) metric canonical targets and inits;
    T0_16 (N, 16) initial blended transforms; mask (N,) bool; the
    skinning MLP's (in, out) weights and (out,) biases; bones16 (24, 16);
    coord_min/coord_max () and center (3,); `packed`: as for kernel B
    (`ops/corr.py:pack_corr` of the dense weights; packed here when not
    given). Returns (x_hat, T16, valid)."""
    if not x_bar.is_cuda:
        return corr_search_rows_plain(x_bar, x0, T0_16, mask, skin_weights_t,
                                      skin_biases, bones16, coord_min,
                                      coord_max, center, max_steps,
                                      cvg_thresh, softmax_scale)
    if packed is None:
        packed = pack_corr([w.T for w in skin_weights_t], skin_biases)
    return launch_corr('corr_rows', x_bar, x0, T0_16, mask, packed, bones16,
                       coord_min, coord_max, center, max_steps, cvg_thresh,
                       softmax_scale, want_active=False)[:3]
