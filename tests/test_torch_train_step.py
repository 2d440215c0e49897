"""The port's train step (`parallel/train_step.py:make_train_step`, no
mesh) against the JAX package's on the CPU: the same parameters, batch and
random draws (the port takes as data what the JAX step draws from its
key: `torch_port_util.jax_draws` replays the JAX step's splits), one
step of Adam over the flagship optimizer groups.

Every loss term, every per-leaf gradient (the port's `.grad` after the
step against `jax.grad` of the same block loss) and the parameters after
the update are compared: with every Pallas kernel forced on the JAX side
(interpret mode, tiles dividing the sizes; the port runs the plain
versions of its kernels), straggler splits off and on; and against the
JAX package's XLA paths.

Tolerances, the robust rules of `test_torch_render.py`: a tracer solve
can move a sample that sits on a convergence threshold to the other side,
so loss terms are held to 1e-3 of their magnitude (+1e-6), and per-leaf
gradients by their cosine (>= 0.999) and their worst element (< 1e-2 of
the leaf's largest magnitude), with the median leaf's worst element
< 1e-4 (measured ~1e-5: reassociation only). Adam's first update is
lr * g / (|g| + eps) per element, which flips with the sign of an
element whose gradient is at roundoff level, so the updates are held
(within 1e-2 of the leaf's largest update) where the gradient exceeds
1e-3 of the leaf's largest; frozen leaves stay bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from torch_port_util import (check_step_vs_jax, jax_draws, jax_scene,
                             port_batch, port_cfg, port_params)

torch.set_num_threads(2)


def _cfg(force: bool, split: bool):
    cfg = small_config(train_skinning=True)
    if force:
        # tiles that divide the 48 rays, their 768 samples and the caps,
        # so that no JAX kernel falls back to XLA
        cfg = cfg._replace(
            pallas_shade_tile=256, pallas_shade_grad_tile=128,
            color=cfg.color._replace(pallas_tile=256, pallas_tile_bwd=128),
            tracer=cfg.tracer._replace(
                pallas_march_tile=16, pallas_iso_tile=16,
                pallas_corr_tile=128, pallas_knn_tile=128))
    if split:
        cfg = cfg._replace(tracer=cfg.tracer._replace(
            march_phase1_steps=3, iso_phase1_steps=3, corr_phase1_steps=3,
            march_resolve_cap=16, iso_resolve_cap=16, corr_resolve_cap=256))
    return cfg


def _jax_step(cfg, params, batch, loss_w, key):
    """(losses, grads, params after the update) of one JAX step."""
    from arah_tpu.parallel.train_step import (TrainState, _block_loss,
                                              make_train_step)
    from arah_tpu.train.optim import OptimConfig, make_optimizer

    def loss_fn(p):
        k = jax.random.split(key, 1)[0]
        l = _block_loss(p, cfg, loss_w, batch, p['latent'][batch.latent_idx],
                        0, k)
        return l['loss'], l
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    opt, _ = make_optimizer(OptimConfig(train_skinning_net=True), params)
    step = make_train_step(cfg, loss_w, opt, donate=False)
    st, _ = step(TrainState(params, opt.init(params), jnp.int32(0)), batch,
                 key)
    return losses, grads, st.params


def _check_step(cfg, monkeypatch, force):
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.train.loss import LossWeights
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.train.loss import LossWeights as PLossWeights
    from arah_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            tree_leaves_with_path)
    if force:
        monkeypatch.setenv('ARAH_FORCE_PALLAS', '1')
    rng = np.random.RandomState(0)
    _, params, fd, _ = jax_scene(cfg, rng, n_rays=8)
    R = 48
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fd, n_blocks=1,
                                  n_rays=R, n_reg=64)
    loss_w = LossWeights(n_ray_loss=R)
    key = jax.random.PRNGKey(2)
    jl, jg, jnew = _jax_step(cfg, params, batch, loss_w, key)

    pp = trainable(port_params(params))
    before = {p: l.detach().clone() for p, l in tree_leaves_with_path(pp)}
    opt, labels = make_optimizer(OptimConfig(train_skinning_net=True), pp)
    step = make_train_step(port_cfg(cfg), PLossWeights(**loss_w._asdict()),
                           opt)
    _, pl = step(TrainState(pp, opt, 0), port_batch(batch),
                 jax_draws(cfg, key, 1, R))
    check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels)


@pytest.mark.parametrize('split', [False, True])
def test_step_vs_jax_kernels(monkeypatch, split):
    """Under ARAH_FORCE_PALLAS=1 (JAX: every Pallas kernel of the step in
    interpret mode, including G, H and I; the port: the plain versions of
    A-I), splits off and on."""
    _check_step(_cfg(True, split), monkeypatch, force=True)


def test_step_vs_jax_xla(monkeypatch):
    """The JAX step on its XLA paths (no forced kernels: linearize
    Jacobian, `siren_shade_grad_xla`, the concat colour MLP)."""
    _check_step(_cfg(False, False), monkeypatch, force=False)
