"""Canonical-correspondence Broyden search: kernel B and its plain version.

`corr_search` launches the CUDA kernel (csrc/corr_rows.cu, the port of
`arah_tpu/ops/pallas/corr_kernel_t.py:corr_search_pallas_t`; one body with
kernel L, `ops/corr_rows.py`) for CUDA tensors and computes
`corr_search_plain` — `solver.root_find.search_canonical_corr` on the same
collapsed skinning MLP — for CPU tensors. Same semantics: per-point
Broyden with best-iterate tracking, masked points frozen at their init,
and the `active` output. Its two options are the TPU kernel's:
`precision` ('split3': every skinning layer after the first as three
bf16 products with f32 sums, `precision.py:dot_split3`; 'bf16': one
product of bf16 operands) and `want_jac` (the exact d fwd_skin / d x_hat
at each returned point, from B's own launch, through the same rounded
products as the primal).

The kernel is a persistent point-slot kernel on `csrc/stream_mlp.cuh`
(kernel F's design): slots refilled from a device-side queue, the live
slots compacted every iteration, the skinning MLP's weights streamed
through shared memory from `put_skin_padded`'s layout, which is the
skinning part of the tracer's `pack_trace`, so the tracer hands its pack
to both (`packed=`). `launch_shape` picks one of two launch shapes by the
number of points, or a third for a skinning MLP wider than 128.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from arah_tpu_torch.core.body import hierarchical_softmax
from arah_tpu_torch.nn.layers import softplus100
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.march import (TracePack, check_pass,
                                      check_skin_dims, frame_vec,
                                      pass_widths, put_skin_padded)
from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                             search_canonical_corr)
from arah_tpu_torch.utils import trace

# (cluster size, widest layer) of csrc/corr_rows.cu's launch shapes
SHAPES = ((1, 128), (2, 128), (1, 256))
# B's variants: the kernel's precision code of each `precision` and its
# symbols (launch shape, precision, want_jac) besides the f32 ones of every
# shape: both options on shapes 0 and 1 (a skinning MLP up to 128 wide)
PRECISIONS = {'f32': 0, 'split3': 1, 'bf16': 2}
VARIANTS = tuple((shape, prec, jac) for shape in (0, 1)
                 for prec in range(3) for jac in (False, True)
                 if prec or jac)


def _bf16(t):
    return t.bfloat16().to(t.dtype)


def split_f32(w):
    """(hi, lo): the bf16 halves of an f32 tensor, w ~ hi + lo
    (`precision.py:split_f32`), as f32 tensors."""
    hi = _bf16(w)
    return hi, _bf16(w - hi)


def dense_skin_fn(skin_weights, skin_biases, softmax_scale: float,
                  precision: str = 'f32'):
    """Normalized points (N, 3) -> (N, 24) weights of a collapsed
    skinning MLP (softplus100 hidden layers, hierarchical softmax). Every
    layer after the first takes `precision`'s products (the corr kernel's
    `layer_dot`): 'split3' hi*hi + lo*hi + hi*lo of bf16 halves with f32
    sums, 'bf16' one product of bf16 operands; forward-mode tangents round
    as the primal does."""
    if precision not in PRECISIONS:
        raise ValueError(f'corr kernel: unknown precision {precision!r}')
    halves = [split_f32(w) for w in skin_weights] \
        if precision == 'split3' else None

    def layer(i, h):
        w = skin_weights[i]
        if i == 0 or precision == 'f32':
            return h @ w.T
        if precision == 'bf16':
            return _bf16(h) @ _bf16(w).T
        (w_hi, w_lo), h_hi = halves[i], _bf16(h)
        h_lo = _bf16(h - h_hi)
        return h_hi @ w_hi.T + h_lo @ w_hi.T + h_hi @ w_lo.T

    def skin_fn(x):
        h = x
        for i in range(len(skin_weights) - 1):
            h = softplus100(layer(i, h) + skin_biases[i])
        logits = layer(len(skin_weights) - 1, h) + skin_biases[-1]
        return hierarchical_softmax(logits * softmax_scale)
    return skin_fn


def corr_search_plain(x_bar, x0, T0_16, mask, skin_weights, skin_biases,
                      bones16, coord_min, coord_max, center,
                      max_steps: int = 50, cvg_thresh: float = 1e-5,
                      softmax_scale: float = 20.0, precision: str = 'f32',
                      want_jac: bool = False, iters=None):
    """Plain version of kernel B; returns (x_hat (N, 3), T16 (N, 16),
    valid (N,), active (N,)) and, with `want_jac`, jac (N, 3, 3): the
    exact d fwd_skin / d x_hat at x_hat (the best iterate, x0 for a masked
    point), [i, k] = d xb_i / d x_k (`ops/skin_jac.py`). Writes each
    point's Broyden iteration count into `iters` ((N,) int32) when
    given."""
    n = x_bar.shape[0]
    frame = CanonicalFrame(bones16.reshape(24, 4, 4),
                           torch.zeros(3, device=x_bar.device),
                           coord_min, coord_max, center)
    res = search_canonical_corr(
        dense_skin_fn(skin_weights, skin_biases, softmax_scale, precision),
        frame, x_bar, x0, T0_16.reshape(n, 4, 4), max_steps=max_steps,
        cvg_thresh=cvg_thresh, active_init=mask)
    if iters is not None:
        iters.copy_(res.iters)
    out = (res.x_hat, res.T_fwd.reshape(n, 16), res.valid & mask,
           res.active)
    if want_jac:
        from arah_tpu_torch.ops.skin_jac import skinning_jac_plain
        out += (skinning_jac_plain(res.x_hat, skin_weights, skin_biases,
                                   frame, softmax_scale, precision),)
    return out


class CorrPack(NamedTuple):
    """Kernel B's pack at a precision other than 'f32' (`pack_corr`): a
    `TracePack` whose skinning layers after the first hold `precision`'s
    weights."""
    params: torch.Tensor
    meta: _build.NetMeta
    precision: str


def pack_precision(packed) -> str:
    """The precision of a corr pack: a `CorrPack`'s, else 'f32'."""
    return getattr(packed, 'precision', 'f32')


def pack_corr(skin_weights, skin_biases, precision: str = 'f32'):
    """The corr kernel's (B and L) pack of a collapsed skinning MLP (dense
    (out, in) weights, (out,) biases): `put_skin_padded`'s layout, the
    skinning blocks of `pack_trace`, a `TracePack`. At another precision a
    `CorrPack`: every layer after the first holds `precision`'s weights,
    made once here: 'bf16' the weights rounded to bf16, 'split3' each
    weight's bf16 halves in one 32-bit word (hi in the upper 16 bits, lo
    in the lower: hi's bits as an f32 are hi itself). Raises on a shape
    the kernel does not take."""
    check_skin_dims(skin_weights, 'corr kernel')
    if precision not in PRECISIONS:
        raise ValueError(f'corr kernel: unknown precision {precision!r}')
    ws = [w.detach() for w in skin_weights]
    if precision == 'bf16':
        ws = [w if i == 0 else _bf16(w) for i, w in enumerate(ws)]
    elif precision == 'split3':
        ws = [w if i == 0 else split_word(w) for i, w in enumerate(ws)]
    pack = _build.ParamPack()
    fields = put_skin_padded(pack, ws, skin_biases)
    meta = _build.NetMeta(**fields)
    if precision == 'f32':
        return TracePack(pack.tensor(), meta)
    return CorrPack(pack.tensor(), meta, precision)


def split_word(w):
    """The f32 tensor whose words hold the bf16 halves (hi, lo) of w: hi's
    16 bits on top, lo's below (bits only; no arithmetic touches them)."""
    hi, lo = split_f32(w.float())
    top = hi.view(torch.int32) & -65536
    bot = (lo.view(torch.int32) >> 16) & 65535
    return (top | bot).view(torch.float32)


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
                iters: torch.Tensor | None = None, want_jac: bool = False):
    """One launch of the corr kernel on CUDA tensors with the skinning
    MLP's pack (`pack_corr`, or the tracer's `pack_trace`; its precision
    is the launch's), counted under `COUNTS[count]` (with `_jac` and
    `_<precision>` appended for B's variants), at launch shape
    `shape` (default `launch_shape` of N and the pack's widest skinning
    layer); writes each point's Broyden iteration count into `iters`
    ((N,) int32) when given. Returns (x_hat, T16, valid, active or None)
    and, with `want_jac`, jac (N, 3, 3), written by the same launch."""
    n = x_bar.shape[0]
    if packed.meta.n_skin == 0:
        raise ValueError('corr kernel: the pack holds no skinning MLP')
    if shape is None:
        shape = launch_shape(n, max(pass_widths(packed.meta, True, False)))
    check_pass('corr', packed.meta, SHAPES, shape, skin=True, siren=False)
    prec = PRECISIONS[pack_precision(packed)]
    if (prec or want_jac) and (shape, prec, want_jac) not in VARIANTS:
        raise ValueError(f'corr kernel: launch shape {shape} runs neither '
                         'want_jac nor a precision other than f32 (a '
                         'skinning MLP up to 128 wide takes them)')
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
    jac = torch.empty((n, 3, 3), dtype=torch.float32, device=dev) \
        if want_jac else None
    counters = torch.empty((2,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.arah_corr(
        x_bar.data_ptr(), x0.data_ptr(), T0_16.data_ptr(), mask.data_ptr(),
        n, bones16.data_ptr(), fvec.data_ptr(), packed.params.data_ptr(),
        packed.meta, int(max_steps), float(cvg_thresh), 1.0, 1e-6,
        float(softmax_scale), int(shape), prec, counters.data_ptr(),
        x_hat.data_ptr(), T16.data_ptr(), valid.data_ptr(),
        None if active is None else active.data_ptr(),
        None if iters is None else iters.data_ptr(),
        None if jac is None else jac.data_ptr(),
        _build.stream_ptr(x_bar)), count)
    trace.COUNTS[count + ('_jac' if want_jac else '')
                 + ('' if prec == 0 else '_' + pack_precision(packed))] += 1
    return (x_hat, T16, valid, active) + ((jac,) if want_jac else ())


def corr_search(x_bar, x0, T0_16, mask, skin_weights, skin_biases, bones16,
                coord_min, coord_max, center, max_steps: int = 50,
                cvg_thresh: float = 1e-5, softmax_scale: float = 20.0,
                precision: str = 'f32', want_jac: bool = False,
                packed: TracePack | None = None, iters=None):
    """Kernel B. x_bar/x0 (N, 3) metric canonical targets and inits;
    T0_16 (N, 16) initial blended transforms; mask (N,) bool; dense (out,
    in) skinning weights and (out,) biases; bones16 (24, 16); coord_min/
    coord_max () and center (3,); `packed`: the skinning MLP's
    `pack_corr` at `precision`, or a `pack_trace` that holds it (the
    tracer's, f32), made once where the kernel runs often (packed here
    when not given); `iters`: an (N,) int32 buffer for each point's
    Broyden iteration count, or None. Returns (x_hat, T16, valid, active)
    and, with `want_jac`, jac (N, 3, 3) (see `corr_search_plain`)."""
    if precision not in PRECISIONS:
        raise ValueError(f'corr kernel: unknown precision {precision!r}')
    if not x_bar.is_cuda:
        return corr_search_plain(x_bar, x0, T0_16, mask, skin_weights,
                                 skin_biases, bones16, coord_min, coord_max,
                                 center, max_steps, cvg_thresh,
                                 softmax_scale, precision, want_jac, iters)
    if packed is None:
        packed = pack_corr(skin_weights, skin_biases, precision)
    if pack_precision(packed) != precision:
        raise ValueError(f'corr kernel: a pack of precision '
                         f'{pack_precision(packed)!r} for precision '
                         f'{precision!r}')
    return launch_corr('corr', x_bar, x0, T0_16, mask, packed, bones16,
                       coord_min, coord_max, center, max_steps, cvg_thresh,
                       softmax_scale, want_active=True, iters=iters,
                       want_jac=want_jac)
