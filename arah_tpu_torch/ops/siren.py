"""Standalone generated-SIREN forward: kernel J and its plain version.

`siren_sdf` launches the CUDA kernel (csrc/siren.cu, the port of
`arah_tpu/ops/pallas/siren_kernel.py:siren_sdf_pallas`) for CUDA tensors
and computes `siren_sdf_plain` (`nn/siren.py:siren_apply`) for CPU
tensors: (N, 3) points -> (N, out_dim) f32 outputs, no gradients. The
differentiable form the tracer uses is `ops/fused.py:make_fused_sdf_fn`.
"""
from __future__ import annotations

import torch

from arah_tpu_torch.nn.siren import GeneratedMLP, siren_apply
from arah_tpu_torch.ops import _build
from arah_tpu_torch.ops.march import pack_siren


def siren_sdf_plain(gen: GeneratedMLP, x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel J: the f32 SIREN forward."""
    return siren_apply(gen, x)


def pack_siren_sdf(gen: GeneratedMLP):
    """(parameter buffer, NetMeta) of a generated SIREN for kernel J;
    raises on a shape it does not take."""
    pack = _build.ParamPack()
    meta = _build.NetMeta(**pack_siren(gen, pack, name='siren kernel',
                                       max_out=256))
    return pack.tensor(), meta


def siren_sdf(gen: GeneratedMLP, x: torch.Tensor,
              packed=None) -> torch.Tensor:
    """Kernel J: (N, 3) f32 points -> (N, out_dim) f32. `packed` is
    `pack_siren_sdf(gen)`, made once where the same SIREN runs often."""
    if not x.is_cuda:
        return siren_sdf_plain(gen, x)
    n = x.shape[0]
    _build.require(x, 'x', torch.float32, (n, 3))
    params, meta = packed if packed is not None else pack_siren_sdf(gen)
    out_dim = gen.weights[-1].shape[0]
    out = torch.empty((n, out_dim), dtype=torch.float32, device=x.device)
    lib = _build.load()
    _build.check(lib.arah_siren(x.data_ptr(), n, params.data_ptr(), meta,
                                out_dim, out.data_ptr(), _build.stream_ptr(x)),
                 'siren')
    _build.COUNTS['siren'] += 1
    return out
