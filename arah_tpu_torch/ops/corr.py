"""Canonical-correspondence Broyden search: kernel B and its plain version.

`corr_search` launches the CUDA kernel (csrc/corr_rows.cu, the port of
`arah_tpu/ops/pallas/corr_kernel_t.py:corr_search_pallas_t`; one body with
kernel L, `ops/corr_rows.py`) for CUDA tensors and computes
`corr_search_plain` — `solver.root_find.search_canonical_corr` on the same
collapsed skinning MLP — for CPU tensors. Same semantics: per-point
Broyden with best-iterate tracking, masked points frozen at their init,
and the `active` output.

The kernel is a persistent point-slot kernel on `csrc/stream_mlp.cuh`
(kernel F's design): slots refilled from a device-side queue, the live
slots compacted every iteration, the skinning MLP's weights streamed
through shared memory from `put_skin_padded`'s layout, which is the
skinning part of the tracer's `pack_trace`, so the tracer hands its pack
to both (`packed=`). `launch_shape` picks one of two launch shapes by the
number of points, or a third for a skinning MLP wider than 128.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.core.body import hierarchical_softmax
from arah_tpu_torch.nn.layers import softplus100
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.march import (TracePack, check_pass,
                                      check_skin_dims, frame_vec,
                                      pass_widths, put_skin_padded)
from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                             search_canonical_corr)

# (cluster size, widest layer) of csrc/corr_rows.cu's launch shapes
SHAPES = ((1, 128), (2, 128), (1, 256))


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


def pack_corr(skin_weights, skin_biases) -> TracePack:
    """The corr kernel's (B and L) pack of a collapsed skinning MLP (dense
    (out, in) weights, (out,) biases): `put_skin_padded`'s layout, the
    skinning blocks of `pack_trace`. Raises on a shape the kernel does not
    take."""
    check_skin_dims(skin_weights, 'corr kernel')
    pack = _build.ParamPack()
    fields = put_skin_padded(pack, skin_weights, skin_biases)
    return TracePack(pack.tensor(), _build.NetMeta(**fields))


def launch_shape(n: int, widest: int = 128) -> int:
    """The corr kernel's launch shape for n points of a skinning MLP whose
    widest layer (padded to 32) is `widest`: up to 128 (the flagship's), 0
    for the thousands of points of phase 1 and the bench, 1 (clusters) for
    a phase-2 batch of at most `corr_resolve_cap` (csrc/corr_rows.cu;
    chosen by a sweep on the H100, PERF.md); wider, 2 (64-point CTAs, up
    to 256) at every n."""
    if widest > 128:
        return 2
    return 0 if n > 4096 else 1


def launch_corr(count: str, x_bar, x0, T0_16, mask, packed: TracePack,
                bones16, coord_min, coord_max, center, max_steps: int,
                cvg_thresh: float, softmax_scale: float, want_active: bool,
                shape: int | None = None,
                iters: torch.Tensor | None = None):
    """One launch of the corr kernel on CUDA tensors with the skinning
    MLP's pack (`pack_corr`, or the tracer's `pack_trace`), counted under
    `COUNTS[count]`, at launch shape `shape` (default `launch_shape` of N
    and the pack's widest skinning layer);
    writes each point's Broyden iteration count into `iters` ((N,) int32)
    when given. Returns (x_hat, T16, valid, active or None)."""
    n = x_bar.shape[0]
    if packed.meta.n_skin == 0:
        raise ValueError('corr kernel: the pack holds no skinning MLP')
    if shape is None:
        shape = launch_shape(n, max(pass_widths(packed.meta, True, False)))
    check_pass('corr', packed.meta, SHAPES, shape, skin=True, siren=False)
    for a, name, shp, dt in (
            (x_bar, 'x_bar', (n, 3), torch.float32),
            (x0, 'x0', (n, 3), torch.float32),
            (T0_16, 'T0_16', (n, 16), torch.float32),
            (mask, 'mask', (n,), torch.bool),
            (bones16, 'bones16', (24, 16), torch.float32)):
        _build.require(a, name, dt, shp)
    fvec = frame_vec(CanonicalFrame(bones16, torch.zeros_like(center),
                                    coord_min, coord_max, center))
    dev = x_bar.device
    x_hat = torch.empty((n, 3), dtype=torch.float32, device=dev)
    T16 = torch.empty((n, 16), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    active = torch.empty((n,), dtype=torch.bool, device=dev) \
        if want_active else None
    counters = torch.empty((2,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.arah_corr(
        x_bar.data_ptr(), x0.data_ptr(), T0_16.data_ptr(), mask.data_ptr(),
        n, bones16.data_ptr(), fvec.data_ptr(), packed.params.data_ptr(),
        packed.meta, int(max_steps), float(cvg_thresh), 1.0, 1e-6,
        float(softmax_scale), int(shape), counters.data_ptr(),
        x_hat.data_ptr(), T16.data_ptr(), valid.data_ptr(),
        None if active is None else active.data_ptr(),
        None if iters is None else iters.data_ptr(),
        _build.stream_ptr(x_bar)), count)
    _build.COUNTS[count] += 1
    return x_hat, T16, valid, active


def corr_search(x_bar, x0, T0_16, mask, skin_weights, skin_biases, bones16,
                coord_min, coord_max, center, max_steps: int = 50,
                cvg_thresh: float = 1e-5, softmax_scale: float = 20.0,
                precision: str = 'f32', want_jac: bool = False,
                packed: TracePack | None = None):
    """Kernel B. x_bar/x0 (N, 3) metric canonical targets and inits;
    T0_16 (N, 16) initial blended transforms; mask (N,) bool; dense (out,
    in) skinning weights and (out,) biases; bones16 (24, 16); coord_min/
    coord_max () and center (3,); `packed`: the skinning MLP's
    `pack_corr`, or a `pack_trace` that holds it (the tracer's), made once
    where the kernel runs often (packed here when not given). Returns
    (x_hat, T16, valid, active)."""
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
    if packed is None:
        packed = pack_corr(skin_weights, skin_biases)
    return launch_corr('corr', x_bar, x0, T0_16, mask, packed, bones16,
                       coord_min, coord_max, center, max_steps, cvg_thresh,
                       softmax_scale, want_active=True)
