"""The A/B switch of the standalone SDF and nearest-vertex kernels (port
of `arah_tpu/ops/fused.py`).

`ARAH_ENABLE_PALLAS=1`, the JAX package's own switch by its own name (so
one A/B command line means the same on both packages), sends the
tracer's no-gradient SDF to kernel J (`make_fused_sdf_fn`, through
`render.renderer.make_sdf_fn(stop_grad=True)`) and every `fused_nn_idx`
to kernel K. Off (the default), both are plain torch. Only the tracer's
unfused loops reach them: the plain march, the plain iso Broyden and, with
`use_pallas_knn` off, the corr init. On a CPU tensor the wrappers compute
their plain versions, so the switch changes nothing there; on a CUDA
tensor they launch the kernel or raise.
"""
from __future__ import annotations

import os

import torch

from arah_tpu_torch.nn.siren import GeneratedMLP
from arah_tpu_torch.ops.knn import nn_idx_plain, nn_idx_rows
from arah_tpu_torch.ops.siren import pack_siren_sdf, siren_sdf, \
    siren_sdf_plain


def pallas_enabled() -> bool:
    """The A/B switch: `ARAH_ENABLE_PALLAS=1`."""
    return os.environ.get('ARAH_ENABLE_PALLAS') == '1'


class _SirenSdf(torch.autograd.Function):
    """Kernel J with the tangents of its plain version (the JAX
    `custom_jvp` of `make_fused_sdf_fn`): forward-mode tangents, as
    `solver.root_find.iso_init_inv_jacobian` takes them, go through
    `siren_sdf_plain`, so no kernel is differentiated. Reverse mode is
    not defined (autograd raises): the tracer runs without gradients."""

    @staticmethod
    def forward(x, gen, packed):
        return siren_sdf(gen, x, packed)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gen, _ = inputs
        ctx.gen = gen
        ctx.save_for_forward(x)

    @staticmethod
    def jvp(ctx, dx, _gen, _packed):
        x, = ctx.saved_tensors
        return torch.func.jvp(lambda p: siren_sdf_plain(ctx.gen, p), (x,),
                              (dx,))[1]


def make_fused_sdf_fn(gen: GeneratedMLP):
    """Normalised points (N, 3) -> (N,) SDF through kernel J, with the
    plain SIREN's tangents. The SIREN is packed once, here."""
    packed = pack_siren_sdf(gen) if gen.weights[0].is_cuda else None
    return lambda x: _SirenSdf.apply(x, gen, packed)[:, 0]


def fused_nn_idx(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Nearest-vertex indices: kernel K under the switch, the plain
    version otherwise."""
    if pallas_enabled():
        return nn_idx_rows(points, verts)
    return nn_idx_plain(points, verts)
