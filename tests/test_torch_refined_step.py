"""The refined flagship step that `chip_smoke.py` drives on the card
(`scene.build_train_setup(refined=True)`: two blocks on two poses, a
patch after each block's loss rays, SMPL and camera refinement and the
perceptual loss), built on the CPU at a few dozen loss rays and a 16 x 16
patch (`scene.PATCH` is 48): its leaves reproduce the batch's frames and
rays, the patch carries all three mask labels, and one step trains every
refinement leaf that has a gradient; with each patch re-centred on a
corner of its frame's box, many of its rays miss the box, and the step
stays finite."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_LOSS, PS = 24, 16


@pytest.fixture
def setup(monkeypatch):
    from arah_tpu_torch import scene
    monkeypatch.setattr(scene, 'PATCH', PS)
    return scene.build_train_setup(scene.flagship_config(), n_rays=N_LOSS,
                                   n_reg=16, pretrain=False, device='cpu',
                                   refined=True)


def test_build_train_setup_refined_on_cpu(setup):
    from arah_tpu_torch.core.smpl import smpl_to_device
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.data.synthetic import synthetic_smpl
    from arah_tpu_torch.parallel.train_step import (_refined_frames,
                                                    _refined_rays)
    from arah_tpu_torch.scene import N_VERTS, flagship_config
    cfg, s, n, ps = flagship_config(), setup, N_LOSS, PS
    R = n + ps * ps
    assert tuple(s.batch.ray_dirs.shape) == (2, R, 3)
    assert s.loss_w.n_ray_loss == n and s.loss_w.patch_size == ps
    for b in range(2):
        labels = s.batch.body_mask[b, n:]
        assert set(labels.unique().tolist()) == {0, 1, 100}
        assert bool((s.batch.rgb_gt[b, n:][labels == 0] == 0).all())
    assert bool((s.batch.body_mask[:, :n] == 1).all())
    assert s.batch.latent_idx.tolist() == [0, 1]

    model = smpl_to_device(synthetic_smpl(n_verts=N_VERTS), 'cpu')
    with torch.no_grad():
        # both blocks' frames in one pass, a row a block
        got = _refined_frames(s.params, model, s.batch.latent_idx)
        for x, y in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(s.batch.frame)):
            torch.testing.assert_close(x, y, rtol=0, atol=2e-6)
        for b in range(2):
            cam, rays = _refined_rays(s.params, s.batch, b)
            assert torch.equal(cam, s.batch.cam_loc[b])
            torch.testing.assert_close(rays, s.batch.ray_dirs[b], rtol=0,
                                       atol=1e-6)
    assert not torch.equal(s.batch.frame.smpl.verts_posed[0],
                           s.batch.frame.smpl.verts_posed[1])

    draws = draw_train_draws(np.random.RandomState(3), cfg, 2, R,
                             device='cpu')
    before = {k: v.detach().clone() for k, v in
              s.params['smpl_params'].items()}
    _, losses = s.step(s.state, s.batch, draws)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert float(losses['perceptual_loss']) > 0
    sp = s.params['smpl_params']
    for k in ('root_orient', 'pose_body', 'pose_hand'):
        g = sp[k].grad
        assert bool((g.abs().amax(-1) > 0).all()), k     # both frames
        assert not torch.equal(sp[k].detach(), before[k])
    assert float(s.params['betas'].grad.abs().max()) > 0
    assert bool((s.params['cam_rots'].grad.abs().amax(-1) > 0).all())
    # as in JAX, translation reaches the loss only through the tracer
    assert float(sp['trans'].grad.abs().max()) == 0
    assert float(s.params['cam_trans'].grad.abs().max()) == 0


def test_refined_step_patch_off_the_box_on_cpu(setup):
    """Each block's patch centred on the top corner of its frame's box,
    as `chip_smoke.py`'s off-box step aims it: a quarter or more of the
    patch rays miss the box (near > far); the loss and every gradient stay
    finite."""
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.scene import append_patch, flagship_config
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    from arah_tpu_torch.utils.tree import tree_map
    s, b_, n = setup, setup.batch, N_LOSS
    base = b_._replace(**{k: getattr(b_, k)[:, :n] for k in (
        'ray_dirs', 'near', 'far', 'rgb_gt', 'body_mask', 'uv')})
    fds = [tree_map(lambda a, _b=b: a[_b], b_.frame) for b in range(2)]
    off = append_patch(base, np.random.RandomState(5), PS, fds,
                       aims=b_.frame.bounds_max)
    assert tuple(off.ray_dirs.shape) == tuple(b_.ray_dirs.shape)
    miss = off.near[:, n:] >= off.far[:, n:]
    assert bool((miss.sum(-1) > PS * PS // 4).all())
    assert bool((off.body_mask[:, n:][miss] == 0).all())
    draws = draw_train_draws(np.random.RandomState(3), flagship_config(), 2,
                             n + PS * PS, device='cpu')
    _, losses = s.step(s.state, off, draws)
    assert all(bool(torch.isfinite(v)) for v in losses.values()), losses
    assert float(losses['perceptual_loss']) > 0
    for path, leaf in tree_leaves_with_path(s.params):
        assert leaf.grad is None or bool(torch.isfinite(leaf.grad).all()), \
            path
