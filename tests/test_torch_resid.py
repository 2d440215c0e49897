"""Kernels C and H with their residents in bf16 (`shade_resid_bf16`, the
TPU kernels' `resid_bf16`): the plain versions against the Pallas
originals in interpret mode, which honour the flag, on the CPU.

Tolerances:
  * against the interpret kernels with the flag, each output and each
    gradient leaf: median |d| within 1e-5 and max |d| within 5e-3 of the
    leaf's largest magnitude (a bf16 store of a reassociated value may
    round to the other neighbour); under `bf16_shading` as well, every
    product operand is a bf16 value that may round to the other
    neighbour, so the median is held at 1e-4, as the C and H tests of
    `test_torch_kernels.py` hold bf16 (measured up to 4e-5);
  * against the port's own flag-off call: the SDF and the features
    bit-equal (the forward chain stays f32), every other leaf within
    2e-2 of its largest magnitude, JAX's own bound
    (`tests/test_pallas.py::test_resid_bf16_film`).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_kernels import _small_gen
from torch_port_util import np_, port_gen, t

torch.set_num_threads(2)


def _leaf_check(a, b, med=1e-5, mx=5e-3):
    a, b = np_(a), np.asarray(b, np.float32)
    scale = max(np.abs(b).max(), 1e-3)
    d = np.abs(a - b) / scale
    assert np.median(d) <= med and d.max() <= mx, (a.shape,
                                                   float(np.median(d)),
                                                   float(d.max()))


def _jax_grads(gen, x, cts, film, bf16, resid):
    """(dx, leaves) of kernel H (interpret) for cotangents cts, in the
    order of the port's GeneratedMLP fields."""
    from arah_tpu.ops.pallas.shade_grad_kernel import _shade_bwd_pallas
    out = _shade_bwd_pallas(gen, jnp.asarray(x), *map(jnp.asarray, cts),
                            tile=32, bf16=bf16, resid_bf16=resid,
                            interpret=True)
    L = len(gen.weights)
    leaves = list(out[1:1 + L]) + [b[0] for b in out[1 + L:1 + 2 * L]]
    if film:
        leaves += list(out[1 + 2 * L]) + list(out[2 + 2 * L])
    return out[0], leaves


@pytest.mark.parametrize('film', [True, False])
@pytest.mark.parametrize('bf16', [False, True])
def test_plain_vs_pallas_resid(rng, film, bf16):
    """C and H with the flag, against `_shade_pallas` and
    `_shade_bwd_pallas` in interpret mode (64 wide, 3 hidden layers, 192
    points), output by output and leaf by leaf."""
    from arah_tpu.ops.pallas.shade_kernel import _shade_pallas
    from arah_tpu_torch.ops.shade import siren_shade
    from arah_tpu_torch.ops.shade_grad import shade_bwd
    gen = _small_gen(rng, film)
    x = rng.uniform(-1, 1, (192, 3)).astype(np.float32)
    med = 1e-4 if bf16 else 1e-5
    ref = _shade_pallas(gen, jnp.asarray(x), 64, bf16, True, True)
    out = siren_shade(port_gen(gen), t(x), bf16=bf16, resid_bf16=True,
                      feat_f32=True)
    for a, b in zip(out, ref):
        _leaf_check(a, b, med)
    cts = [rng.randn(192, d).astype(np.float32) for d in (1, 64, 3)]
    jdx, jleaves = _jax_grads(gen, x, cts, film, bf16, True)
    dx, d = shade_bwd(port_gen(gen), t(x), *map(t, cts), bf16=bf16,
                      resid_bf16=True)
    leaves = [a for part in d for a in part]
    assert len(leaves) == len(jleaves)
    for a, b in zip([dx] + leaves, [jdx] + jleaves):
        _leaf_check(a, b, med)


@pytest.mark.parametrize('film', [True, False])
def test_resid_moves_only_the_normal(rng, film):
    """With the flag the SDF and the features equal the flag-off call's
    bit for bit; the normal and every gradient leaf of H stay within JAX's
    2e-2, and the flag does move the normal."""
    from arah_tpu_torch.ops.shade import siren_shade
    from arah_tpu_torch.ops.shade_grad import shade_bwd
    gen = port_gen(_small_gen(rng, film))
    x = t(rng.uniform(-1, 1, (192, 3)).astype(np.float32))
    o0, f0, n0 = siren_shade(gen, x, feat_f32=True)
    o1, f1, n1 = siren_shade(gen, x, resid_bf16=True, feat_f32=True)
    assert torch.equal(o0, o1) and torch.equal(f0, f1)
    assert not torch.equal(n0, n1)
    _leaf_check(n1, np_(n0), med=2e-2, mx=2e-2)
    cts = [t(rng.randn(192, d).astype(np.float32)) for d in (1, 64, 3)]
    dx0, d0 = shade_bwd(gen, x, *cts)
    dx1, d1 = shade_bwd(gen, x, *cts, resid_bf16=True)
    for a, b in zip([dx1] + [a for p in d1 for a in p],
                    [dx0] + [a for p in d0 for a in p]):
        _leaf_check(a, np_(b), med=2e-2, mx=2e-2)


def test_op_gradients_reach_h_with_the_flag(rng, monkeypatch):
    """`siren_shade_grad(resid_bf16=True)`: the backward hands the flag to
    kernel H, and the op's gradients are H's with the flag against JAX's
    fused op (Pallas interpret) with it."""
    from arah_tpu.ops.pallas.shade_grad_kernel import siren_shade_grad as jop
    from arah_tpu_torch.ops import shade_grad
    gen = _small_gen(rng, True)
    x = rng.uniform(-1, 1, (192, 3)).astype(np.float32)
    cts = [rng.randn(192, d).astype(np.float32) for d in (1, 64, 3)]

    def loss(g, p):
        return sum(jnp.sum(o * c) for o, c in zip(
            jop(g, p, tile=64, tile_bwd=32, resid_bf16=True,
                interpret=True), cts))
    gref = jax.grad(loss, argnums=(0, 1))(gen, jnp.asarray(x))
    seen, real = [], shade_grad.shade_bwd

    def spy(*a, **k):
        seen.append(a[6] if len(a) > 6 else k.get('resid_bf16'))
        return real(*a, **k)
    monkeypatch.setattr(shade_grad, 'shade_bwd', spy)
    pg = port_gen(gen)
    leaves = [a.requires_grad_() for part in pg for a in part]
    xt = t(x).requires_grad_()
    outs = shade_grad.siren_shade_grad(pg, xt, resid_bf16=True)
    sum(torch.sum(o * t(c)) for o, c in zip(outs, cts)).backward()
    assert seen == [True]
    ref_leaves = jax.tree.leaves(gref[0]) + [gref[1]]
    for a, b in zip(leaves + [xt], ref_leaves):
        _leaf_check(a.grad, b)
