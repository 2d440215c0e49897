"""The port's batch path against the JAX package's on the CPU:
`data/batch.py` (the numpy augmentation draws, per-block-frame synthetic
batches), `data/loader.py` (collation in both modes, the device copy,
both samplers, the prefetcher) on items of the fake ZJU-layout dataset
written under a temporary directory, and the train step with per-block
frames (tolerances of `test_torch_train_step.py`). What the port copied
from numpy code gives equal bits."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from torch_port_util import (check_step_vs_jax, jax_step, port_step,
                             refine_scene)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def fake_items(tmp_path_factory):
    """(dataset, its items 0..3 drawn once): 2 frames x 2 views."""
    from arah_tpu.data.fake_dataset import make_fake_zju_dataset
    from arah_tpu.data.human_video import ZJUMoCapDataset
    root = str(tmp_path_factory.mktemp('fake_zju'))
    misc_dir, _ = make_fake_zju_dataset(root, n_frames=2, views=('1', '7'),
                                        img_size=256, n_verts=512)
    ds = ZJUMoCapDataset(
        root, smpl_misc_dir=misc_dir, subjects=('CoreView_313',),
        mode='train', img_size=(128, 128), num_fg_samples=32,
        num_bg_samples=32, sample_reg_surface=True, sample_inside=True,
        erode_mask=False, seed=0)
    return ds, [ds[i] for i in range(len(ds))]


class _Frozen:
    """The dataset's records with items fixed at their first draw, so
    that two loaders see the same rays."""

    def __init__(self, ds, items):
        self.data, self.items = ds.data, items

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def assert_trees_equal(port, ref):
    pl = jax.tree_util.tree_leaves_with_path(
        port, is_leaf=lambda x: torch.is_tensor(x))
    jl = jax.tree_util.tree_leaves_with_path(ref)
    assert [str(p) for p, _ in pl] == [str(p) for p, _ in jl]
    for (path, a), (_, b) in zip(pl, jl):
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                          b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize('kind', ['rotation', 'gaussian'])
def test_noise_draws_vs_jax(kind):
    from arah_tpu.data import batch as J
    from arah_tpu_torch.data import batch as P
    assert_trees_equal(P.identity_noise_np(3, 5, kind),
                       J.identity_noise_np(3, 5, kind))
    for seed in range(8):
        a = P.sample_noise(np.random.RandomState(seed), 3, True, True, kind,
                           n_rays=5)
        b = J.sample_noise(np.random.RandomState(seed), 3, True, True, kind,
                           n_rays=5)
        assert_trees_equal(a, b)
    for seed in range(4):
        np.testing.assert_array_equal(
            P.augm_rots(np.random.RandomState(seed)),
            J.augm_rots(np.random.RandomState(seed)))


@pytest.mark.parametrize('per_block_frame', [False, True])
def test_collate_vs_jax(fake_items, per_block_frame):
    """Both modes bit-equal to JAX's collation; the device copy keeps the
    values in JAX's default dtypes."""
    from arah_tpu.data.loader import collate_train_batch_np as J
    from arah_tpu_torch.data.loader import (batch_to_device,
                                            collate_train_batch_np as P)
    from arah_tpu_torch.data.batch import sample_noise
    ds, items = fake_items
    sel = [items[0], items[3]] if per_block_frame else [items[0], items[1]]
    noise = sample_noise(np.random.RandomState(0), 2, True, True)
    pb = P(sel, noise, per_block_frame=per_block_frame)
    jb = J(sel, noise, per_block_frame=per_block_frame)
    assert_trees_equal(pb, jb)
    if per_block_frame:
        assert pb.frame.frame.bone_transforms.shape == (2, 24, 4, 4)
        assert pb.latent_idx.tolist() == [items[0]['inputs.data_idx'],
                                          items[3]['inputs.data_idx']]
    assert_trees_equal(batch_to_device(pb, 'cpu'),
                       jax.tree.map(jnp.asarray, jb))
    if not per_block_frame:
        from arah_tpu.data.loader import collate_train_batch as Jd
        from arah_tpu_torch.data.loader import collate_train_batch as Pd
        assert_trees_equal(Pd(sel, noise, device='cpu'), Jd(sel, noise))


def test_frame_from_item_vs_jax(fake_items):
    from arah_tpu.data.loader import frame_from_item as J
    from arah_tpu_torch.data.loader import frame_from_item as P
    _, items = fake_items
    assert_trees_equal(P(items[2], device='cpu'), J(items[2]))


def test_samplers_vs_jax(fake_items):
    """The same index lists for a seed, sharded or not."""
    from arah_tpu.data import loader as J
    from arah_tpu_torch.data import loader as P
    ds, _ = fake_items
    for kw in ({}, {'shuffle': False}, {'seed': 5, 'num_shards': 2,
                                        'shard_id': 1},
               {'block_multiple': 3}):
        a = P.FrameBatchSampler(ds, **kw)
        b = J.FrameBatchSampler(ds, **kw)
        assert len(a) == len(b)
        for _ in range(3):
            assert list(a) == list(b)
    for kw in ({'batch_size': 2}, {'batch_size': 3, 'seed': 7},
               {'batch_size': 1, 'shard_id': 1, 'num_shards': 2}):
        a = P.MultiFrameBatchSampler(ds, **kw)
        b = J.MultiFrameBatchSampler(ds, **kw)
        assert len(a) == len(b)
        for _ in range(3):
            assert list(a) == list(b)


def test_prefetcher_vs_jax(fake_items):
    """The port's prefetcher hands out JAX's batches in JAX's order: the
    numpy collate on the pool, the device copy on the consumer thread."""
    import threading
    from arah_tpu.data import loader as J
    from arah_tpu_torch.data import loader as P
    ds, items = fake_items
    frozen = _Frozen(ds, items)
    threads = set()

    def to_cpu(b):
        threads.add(threading.current_thread())
        return P.batch_to_device(b, 'cpu')
    for per_block in (False, True):
        def collate(its, _p=per_block):
            return P.collate_train_batch_np(its, per_block_frame=_p)

        def jcollate(its, _p=per_block):
            return J.collate_train_batch_np(its, per_block_frame=_p)
        sampler = (P.MultiFrameBatchSampler(ds, 2, seed=1) if per_block
                   else P.FrameBatchSampler(ds, seed=1))
        jsampler = (J.MultiFrameBatchSampler(ds, 2, seed=1) if per_block
                    else J.FrameBatchSampler(ds, seed=1))
        with P.Prefetcher(frozen, sampler, collate, n_workers=2,
                          postprocess=to_cpu) as pf:
            got = list(pf)
        jpf = J.Prefetcher(frozen, jsampler, jcollate, n_workers=2)
        want = list(jpf)
        jpf.close()
        assert len(got) == len(want) == len(sampler)
        for a, b in zip(got, want):
            assert_trees_equal(a, b)
    assert threads == {threading.main_thread()}


def test_synthetic_per_block_frame_batch():
    """`synthetic_train_batch(fds=...)`: JAX's structure (frame leaves
    stacked on the block dimension, latent indices 0..B-1), each block's
    rays aimed at its own frame's vertices."""
    from arah_tpu.data.batch import synthetic_train_batch as J
    from arah_tpu_torch.data.batch import synthetic_train_batch as P
    from torch_port_util import port_frame_data
    _, _, fds = refine_scene(small_config(), np.random.RandomState(0), 2)
    jb = J(jax.random.PRNGKey(1), fds[0], n_blocks=2, n_rays=16, n_reg=8,
           fds=fds)
    pfds = [port_frame_data(f) for f in fds]
    pb = P(np.random.RandomState(1), pfds[0], n_blocks=2, n_rays=16,
           n_reg=8, fds=pfds)
    pl = jax.tree_util.tree_leaves_with_path(
        pb, is_leaf=lambda x: torch.is_tensor(x))
    jl = jax.tree_util.tree_leaves_with_path(jb)
    assert [str(p) for p, _ in pl] == [str(p) for p, _ in jl]
    for (path, a), (_, b) in zip(pl, jl):
        assert tuple(a.shape) == np.shape(b), path
    assert pb.latent_idx.tolist() == [0, 1]
    for b in range(2):
        verts = pfds[b].smpl.verts_posed
        # every ray passes within 1e-4 of one of its frame's vertices
        rel = verts[None] - pb.cam_loc[b][None, None]
        d = pb.ray_dirs[b][:, None, :]
        off = rel - (rel * d).sum(-1, keepdim=True) * d
        assert float(off.norm(dim=-1).amin(-1).max()) < 1e-4
        np.testing.assert_array_equal(pb.frame.bounds_min[b].numpy(),
                                      pfds[b].bounds_min.numpy())


def test_step_per_block_frame_vs_jax():
    """Case (c): `per_block_frame`, 2 blocks on 2 frames (latent rows 0
    and 1)."""
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.train.loss import LossWeights
    cfg = small_config(train_skinning=True)
    _, params, fds = refine_scene(cfg, np.random.RandomState(0), 2)
    del params['smpl_params'], params['betas']
    R = 48
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fds[0], n_blocks=2,
                                  n_rays=R, n_reg=64, fds=fds)
    loss_w = LossWeights(n_ray_loss=R)
    key = jax.random.PRNGKey(2)
    jl, jg, jnew = jax_step(cfg, params, batch, loss_w, key, 2,
                            per_block_frame=True)
    pl, pp, before, labels = port_step(cfg, params, batch, loss_w, key, 2,
                                       R, per_block_frame=True)
    grads = check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels)
    pg, g = grads[('latent',)]
    # both blocks' latent rows have a gradient, the third row none
    for row in (0, 1):
        assert np.abs(g[row]).max() > 0 and np.abs(pg[row]).max() > 0
    assert np.abs(g[2]).max() == 0 and np.abs(pg[2]).max() == 0


def test_prefetcher_draws_as_one_worker(tmp_path):
    """More workers than cores, every batch in flight and a short switch
    interval: with a seed, every batch, the dataset's draws and a collate
    that draws input noise as the trainer's does, is bit-equal to a serial
    one-worker run's from batch k's generator `RandomState([*seed, k])`,
    in sampler order, twice."""
    import os
    import sys
    from arah_tpu_torch.data import loader as P
    from arah_tpu_torch.data.batch import sample_noise
    from arah_tpu_torch.data.fake_dataset import make_fake_zju_dataset
    from arah_tpu_torch.data.human_video import ZJUMoCapDataset
    from arah_tpu_torch.utils.tree import tree_map
    root = str(tmp_path / 'fake')
    misc, _ = make_fake_zju_dataset(root, n_frames=4, views=('1', '7'),
                                    img_size=128, n_verts=256)
    ds = ZJUMoCapDataset(
        root, smpl_misc_dir=misc, subjects=('CoreView_313',),
        mode='train', img_size=(64, 64), num_fg_samples=16,
        num_bg_samples=16, sample_reg_surface=True, sample_inside=True,
        seed=3)

    def collate(items, rng):
        return P.collate_train_batch_np(items, sample_noise(
            rng, len(items), True, True, n_rays=32))

    def run(workers):
        sampler = P.FrameBatchSampler(ds, seed=1)
        if workers == 0:
            out = []
            for k, idxs in enumerate(sampler):
                rng = np.random.RandomState([5, 0, k])
                out.append(collate([ds.item(i, rng) for i in idxs], rng))
            return out
        with P.Prefetcher(ds, sampler, collate, n_workers=workers,
                          depth=workers, seed=(5, 0)) as pf:
            return list(pf)
    want = run(0)
    assert len(want) == 4
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runs = [run(2 * (os.cpu_count() or 4)) for _ in range(2)]
    finally:
        sys.setswitchinterval(interval)
    for got in runs:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            tree_map(np.testing.assert_array_equal, a, b)
