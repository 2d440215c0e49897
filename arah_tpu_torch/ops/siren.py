"""Standalone generated-SIREN forward: kernel J and its plain version.

`siren_sdf` launches the CUDA kernel (csrc/siren.cu, the port of
`arah_tpu/ops/pallas/siren_kernel.py:siren_sdf_pallas`) for CUDA tensors
and computes `siren_sdf_plain` (`nn/siren.py:siren_apply`) for CPU
tensors: (N, 3) points -> (N, out_dim) f32 outputs, no gradients. The
differentiable form the tracer uses is `ops/fused.py:make_fused_sdf_fn`.

The kernel is kernel E's network pass on `csrc/stream_mlp.cuh`: a
persistent grid walks R-point tiles, each one pass of the hidden layers
with the weights streamed through shared memory; `launch_shape` picks
64-point tiles for thousands of points and clusters that split each
layer's units over their CTAs for the small batches of the tracer's
plain loops.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.nn.siren import GeneratedMLP, siren_apply
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.march import check_pass, pack_siren
from arah_tpu_torch.utils import trace

# (cluster size, widest layer) of csrc/siren.cu's launch shapes
SHAPES = ((1, 256), (2, 256))


def siren_sdf_plain(gen: GeneratedMLP, x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel J: the f32 SIREN forward."""
    return siren_apply(gen, x)


def pack_siren_sdf(gen: GeneratedMLP):
    """(parameter buffer, NetMeta) of a generated SIREN for kernel J,
    every block at a multiple of 4 floats (16-byte copies into the
    kernel's shared-memory ring); raises on a shape it does not take."""
    pack = _build.ParamPack()
    meta = _build.NetMeta(**pack_siren(gen, pack, name='siren kernel',
                                       max_out=256, align=4))
    return pack.tensor(), meta


def launch_shape(n: int) -> int:
    """Kernel J's launch shape for n points: 0 (64-point tiles) for
    thousands, 1 (clusters) for the plain loops' small batches
    (csrc/siren.cu; chosen by a sweep on the H100, PERF.md)."""
    return 0 if n > 2048 else 1


def launch_siren(x: torch.Tensor, packed, out_dim: int,
                 shape: int) -> torch.Tensor:
    """One launch of kernel J on a checked (N, 3) CUDA tensor at launch
    shape `shape`, with its pack (`pack_siren_sdf`)."""
    params, meta = packed
    check_pass('siren', meta, SHAPES, shape, skin=False, siren=True)
    n = x.shape[0]
    out = torch.empty((n, out_dim), dtype=torch.float32, device=x.device)
    lib = _build.load()
    _build.check(lib.arah_siren(x.data_ptr(), n, params.data_ptr(), meta,
                                out_dim, int(shape), out.data_ptr(),
                                _build.stream_ptr(x)), 'siren')
    trace.COUNTS['siren'] += 1
    return out


def siren_sdf(gen: GeneratedMLP, x: torch.Tensor,
              packed=None) -> torch.Tensor:
    """Kernel J: (N, 3) f32 points -> (N, out_dim) f32. `packed` is
    `pack_siren_sdf(gen)`, made once where the same SIREN runs often."""
    if not x.is_cuda:
        return siren_sdf_plain(gen, x)
    n = x.shape[0]
    _build.require(x, 'x', torch.float32, (n, 3))
    if packed is None:
        packed = pack_siren_sdf(gen)
    return launch_siren(x, packed, gen.weights[-1].shape[0], launch_shape(n))
