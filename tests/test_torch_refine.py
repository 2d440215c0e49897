"""SMPL and camera refinement in the port against the JAX package on the
CPU: `core/smpl.py` (`quat_to_rot`, `load_smpl_assets`), the
differentiable `model.prepare_frame`, the two leaf initialisers of
`config/factory.py`, and the train step with `refine_smpl` and
`refine_cameras` (tolerances of `test_torch_train_step.py`).

Which refinement leaves have a gradient is JAX's answer, held leaf by
leaf: the pose and shape leaves and the camera rotations do; the SMPL
translation and the camera translation do not (they reach the loss only
through the tracer, which runs without gradients, and the 'latent'
colour pose encoder reads no joint position), so both sides give them
exactly zero."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from torch_port_util import (MOVED, STILL, check_step_vs_jax, jax_step,
                             port_smpl, port_step, refine_scene, t)

torch.set_num_threads(2)


def test_quat_to_rot_vs_jax(rng):
    from arah_tpu.core.smpl import quat_to_rot as J
    from arah_tpu_torch.core.smpl import quat_to_rot as P
    q = rng.randn(16, 4).astype(np.float32)
    q[0] = [0.0, 0.0, 0.0, 1.0]
    np.testing.assert_allclose(P(t(q)).numpy(), np.asarray(J(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_array_equal(P(t(q[0])).numpy(), np.eye(3))


def test_load_smpl_assets_vs_jax(tmp_path):
    """The reference npz layout, written from the synthetic body as the
    fake dataset writes it, loads into equal arrays (parents on the CPU,
    the rest on the requested device)."""
    from arah_tpu.core.smpl import load_smpl_assets as J
    from arah_tpu.data.fake_dataset import write_smpl_misc
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu_torch.core.smpl import load_smpl_assets as P
    misc = str(tmp_path / 'misc')
    write_smpl_misc(misc, synthetic_smpl(n_verts=256, seed=3))
    for gender in ('neutral', 'female'):
        jm, pm = J(misc, gender), P(misc, gender, device='cpu')
        assert jm._fields == pm._fields
        for f in jm._fields:
            a, b = np.asarray(getattr(jm, f)), getattr(pm, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        assert pm.parents.device.type == 'cpu'


def test_prepare_frame_gradients_vs_jax(rng):
    """d/d(betas, pose, trans) of a fixed random weighting of every leaf
    of the frame, against `jax.grad` of the same scalar (rel 1e-4)."""
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu.model import prepare_frame as J
    from arah_tpu_torch.model import prepare_frame as P
    model = synthetic_smpl(n_verts=256)
    betas = (rng.randn(10) * 0.3).astype(np.float32)
    pose = (rng.randn(72) * 0.2).astype(np.float32)
    trans = np.asarray([0.1, 0.05, 0.2], np.float32)
    fd = J(model, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(trans))
    ws = [np.asarray(rng.randn(*np.shape(a)), np.float32)
          for a in jax.tree_util.tree_leaves(fd)]

    def jscalar(b, p, tr):
        leaves = jax.tree_util.tree_leaves(J(model, b, p, tr))
        return sum(jnp.sum(a * w) for a, w in zip(leaves, ws))
    jg = jax.grad(jscalar, argnums=(0, 1, 2))(
        jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(trans))

    args = [t(a).requires_grad_(True) for a in (betas, pose, trans)]
    pfd = P(port_smpl(model), *args, device='cpu')
    leaves = jax.tree_util.tree_leaves(
        pfd, is_leaf=lambda x: torch.is_tensor(x))
    assert len(leaves) == len(ws)
    s = sum(torch.sum(a * t(w)) for a, w in zip(leaves, ws))
    pg = torch.autograd.grad(s, args)
    for name, a, b in zip(('betas', 'pose', 'trans'), pg, jg):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        rel = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert rel < 1e-4, (name, rel)


def test_prepare_frame_keeps_the_graph_across_devices_and_dtypes():
    """A float64 input on another device than `device` keeps its graph
    (it did not, when the inputs were rebuilt through numpy)."""
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu_torch.model import prepare_frame
    model = port_smpl(synthetic_smpl(n_verts=128))
    pose = torch.zeros(72, dtype=torch.float64, requires_grad=True)
    fd = prepare_frame(model, torch.zeros(10), pose, torch.zeros(3),
                       device='cpu')
    assert fd.rots_full.dtype == torch.float32
    fd.rots_full.sum().backward()
    assert pose.grad is not None and pose.grad.dtype == torch.float64
    with torch.no_grad():
        assert not prepare_frame(model, torch.zeros(10), pose,
                                 torch.zeros(3), device='cpu') \
            .frame.bone_transforms.requires_grad


class _StandIn:
    """What the two initialisers read of a dataset: `data` records
    (`cam_idx`, `model_file`), `cam_names` and `cameras`."""

    def __init__(self, root, rng, n_frames=3, cams=('1', '7')):
        self.data, self.cameras = [], {}
        self.cam_names = list(cams)
        for ci, name in enumerate(cams):
            R = np.linalg.qr(rng.randn(3, 3))[0]
            R *= np.sign(np.linalg.det(R))
            self.cameras[name] = {'R': R, 'T': rng.randn(3, 1)}
            for f in range(n_frames):
                path = os.path.join(root, f'{f:06d}.npz')
                if ci == 0:
                    body = rng.randn(63) * 0.2
                    body[3:6] = 0.0      # an all-zero joint: fixed up
                    np.savez(path, root_orient=np.zeros(3) if f == 1
                             else rng.randn(3), pose_body=body,
                             pose_hand=np.zeros(6), trans=rng.randn(3),
                             **({'betas': rng.randn(10)} if f == 0 else {}))
                self.data.append({'cam_idx': ci, 'model_file': path})


def test_factory_initialisers_vs_jax(rng, tmp_path):
    from arah_tpu.config.factory import (camera_params_from_dataset as Jc,
                                         smpl_refine_params_from_dataset
                                         as Js)
    from arah_tpu_torch.config.factory import (
        camera_params_from_dataset as Pc,
        smpl_refine_params_from_dataset as Ps)
    ds = _StandIn(str(tmp_path), rng)
    js, ps = Js(ds), Ps(ds, device='cpu')
    jl = jax.tree_util.tree_leaves_with_path(js)
    pl = jax.tree_util.tree_leaves_with_path(
        ps, is_leaf=lambda x: torch.is_tensor(x))
    assert [str(p) for p, _ in jl] == [str(p) for p, _ in pl]
    for (path, a), (_, b) in zip(jl, pl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=str(path))
    assert ps['smpl_params']['pose_body'].shape == (3, 63)
    assert (ps['smpl_params']['pose_hand'] != 0).all()
    for a, b in zip(Jc(ds), Pc(ds, device='cpu')):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))




def test_step_refine_smpl_and_cameras_vs_jax():
    """Case (a): `refine_smpl` with `refine_cameras`, one block on frame 0
    of two; camera leaves that reproduce the batch's rays (an identity
    quaternion, `cam_trans = -cam_loc`, `uv = ray_dirs`)."""
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.train.loss import LossWeights
    cfg = small_config(train_skinning=True)
    model, params, fds = refine_scene(cfg, np.random.RandomState(0), 2)
    R = 48
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fds[0], n_blocks=1,
                                  n_rays=R, n_reg=64)
    params['cam_rots'] = jnp.asarray([[0.0, 0.0, 0.0, 1.0]])
    params['cam_trans'] = -batch.cam_loc
    loss_w = LossWeights(n_ray_loss=R)
    key = jax.random.PRNGKey(2)
    opts = dict(refine_smpl=True, refine_cameras=True)
    jl, jg, jnew = jax_step(cfg, params, batch, loss_w, key, 1,
                            smpl_model=model, **opts)
    pl, pp, before, labels = port_step(cfg, params, batch, loss_w, key, 1,
                                       R, smpl_model=port_smpl(model),
                                       **opts)
    grads = check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels)
    for path in MOVED:
        pg, g = grads[path]
        if path[0] == 'smpl_params':
            # frame 1 is not in the batch: its row has no gradient
            assert np.abs(g[0]).max() > 0 and np.abs(pg[0]).max() > 0, path
            assert np.abs(g[1]).max() == 0 and np.abs(pg[1]).max() == 0
        else:
            assert np.abs(g).max() > 0 and np.abs(pg).max() > 0, path
    for path in STILL:
        pg, g = grads[path]
        assert np.abs(g).max() == 0 and np.abs(pg).max() == 0, path
        assert labels[path] == 'aux'


def test_step_refine_needs_the_smpl_model():
    from arah_tpu_torch.parallel.train_step import make_train_step
    from arah_tpu_torch.train.loss import LossWeights
    with pytest.raises(ValueError, match='smpl_model'):
        make_train_step(None, LossWeights(), None, refine_smpl=True)
