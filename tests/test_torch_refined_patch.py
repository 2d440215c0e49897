"""The refined step with every option at once against the JAX package
on the CPU (tolerances of `test_torch_train_step.py`, through
`check_step_vs_jax`): case (d), `refine_smpl`, `refine_cameras` and
`per_block_frame` on 2 frames, each block with a 16 x 16 patch after its
48 loss rays and the perceptual loss on. The block's frame comes from
the SMPL leaves at the block's latent row, a device index, and its rays
from its camera leaves."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from test_renderer import small_config
from torch_port_util import (MOVED, STILL, check_step_vs_jax, jax_step,
                             patch_labels, port_smpl, port_step,
                             refine_scene)

torch.set_num_threads(2)

N_LOSS, PS = 48, 16


def test_step_refined_per_block_patch_vs_jax():
    """Case (d): every refinement leaf held by name, each row of the
    per-frame SMPL leaves and of the camera leaves with a gradient on
    both sides."""
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.train.loss import LossWeights
    cfg = small_config(train_skinning=True)
    model, params, fds = refine_scene(cfg, np.random.RandomState(0), 2)
    R = N_LOSS + PS * PS
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fds[0], n_blocks=2,
                                  n_rays=R, n_reg=64, fds=fds)
    batch = batch._replace(body_mask=patch_labels(2, N_LOSS, PS))
    params['cam_rots'] = jnp.asarray([[0.0, 0.0, 0.0, 1.0]] * 2)
    params['cam_trans'] = -batch.cam_loc
    loss_w = LossWeights(n_ray_loss=N_LOSS, perceptual=1.0, patch_size=PS)
    key = jax.random.PRNGKey(2)
    opts = dict(refine_smpl=True, refine_cameras=True, per_block_frame=True)
    jl, jg, jnew = jax_step(cfg, params, batch, loss_w, key, 2,
                            smpl_model=model, **opts)
    pl, pp, before, labels = port_step(cfg, params, batch, loss_w, key, 2,
                                       R, smpl_model=port_smpl(model),
                                       **opts)
    grads = check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels)
    assert np.isfinite(float(pl['perceptual_loss']))
    assert float(pl['perceptual_loss']) > 0
    for path in MOVED:
        pg, g = grads[path]
        rows = (0, 1) if g.ndim == 2 else (Ellipsis,)
        for row in rows:
            assert np.abs(g[row]).max() > 0, (path, row)
            assert np.abs(pg[row]).max() > 0, (path, row)
    for path in STILL:
        pg, g = grads[path]
        assert np.abs(g).max() == 0 and np.abs(pg).max() == 0, path
