"""A patch that leaves the frame's box, in the port's step against the
JAX package's on the CPU (tolerances of `test_torch_train_step.py`,
through `check_step_vs_jax`).

The dataset appends its patch around a foreground pixel without
filtering its rays by the box (`data/human_video.py`), so a patch at the
body's edge holds rays that miss it (near > far). JAX samples such a ray
from near down to far; the negative intervals composite to NaN, and its
perceptual loss and gradient are NaN, a fault of the reference that the
test holds. The port masks every sample of a ray that misses the box
(`render/ray_tracing.py:sample_z_vals`), which then composites to the
background; it is held against JAX with the same mask put on JAX's
sampler for the test."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from test_renderer import small_config
from torch_port_util import (check_step_vs_jax, jax_scene, jax_step,
                             patch_labels, port_step)

torch.set_num_threads(2)

N_LOSS, PS = 48, 16


def test_step_patch_off_the_box_vs_jax(monkeypatch):
    """The last 40 rays of the patch aimed past the box (near > far):
    JAX's perceptual loss and total loss are NaN; the port's are finite
    and match JAX's with the port's mask on JAX's sampler."""
    from arah_tpu.core.rays import ray_aabb
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.parallel.train_step import _block_loss
    from arah_tpu.render import ray_tracing as jrt
    from arah_tpu.train.loss import LossWeights
    from arah_tpu.utils.lpips_jax import make_perceptual_loss
    cfg = small_config(train_skinning=True)
    _, params, fd, _ = jax_scene(cfg, np.random.RandomState(0), n_rays=8)
    R = N_LOSS + PS * PS
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fd, n_blocks=1,
                                  n_rays=R, n_reg=64)
    cam = np.asarray(batch.cam_loc)[0]
    past = np.asarray(fd.bounds_max) + np.asarray([1.0, 0.5, 0.0]) - cam
    dirs = np.array(batch.ray_dirs)
    dirs[0, R - 40:] = past / np.linalg.norm(past) \
        + np.random.RandomState(3).randn(40, 3) * 0.01
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    near, far, hit = ray_aabb(fd.bounds_min, fd.bounds_max,
                              jnp.broadcast_to(jnp.asarray(cam),
                                               dirs.shape[1:]), dirs[0])
    assert np.asarray(~hit[R - 40:]).all() and np.asarray(hit[:R - 40]).all()
    batch = batch._replace(ray_dirs=dirs, uv=dirs, near=near[None],
                           far=far[None], body_mask=patch_labels(1, N_LOSS, PS))
    loss_w = LossWeights(n_ray_loss=N_LOSS, perceptual=1.0, patch_size=PS)
    key = jax.random.PRNGKey(2)

    # the reference's fault: the forward alone is NaN
    jl = jax.jit(lambda p: _block_loss(
        p, cfg, loss_w, batch, p['latent'][batch.latent_idx], 0,
        jax.random.split(key, 1)[0],
        perceptual_fn=make_perceptual_loss()))(params)
    assert np.isnan(float(jl['perceptual_loss']))
    assert np.isnan(float(jl['loss']))
    assert np.isfinite(float(jl['rgb_loss']))

    real = jrt.sample_z_vals

    def masked(cfg_, key_, body_mask, surface_depth, near_, far_, eval_mode):
        z, m = real(cfg_, key_, body_mask, surface_depth, near_, far_,
                    eval_mode)
        return z, m & (near_ < far_)[:, None]
    monkeypatch.setattr(jrt, 'sample_z_vals', masked)
    jl, jg, jnew = jax_step(cfg, params, batch, loss_w, key, 1)
    pl, pp, before, labels = port_step(cfg, params, batch, loss_w, key, 1, R)
    check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels)
    assert np.isfinite(float(pl['perceptual_loss']))
    assert float(pl['perceptual_loss']) > 0
