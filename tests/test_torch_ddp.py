"""The port's data-parallel train step (`make_train_step(mesh=...)` over
two gloo ranks on the CPU, `tests/torch_mp_worker.py`) against the JAX
package's: the same parameters, global batch and draws, with rank r's
draws replayed from `fold_in(key, r)` as JAX's sharded step folds the
axis index into its key.

Two steps are held against JAX's `make_train_step(mesh=make_mesh(2))` on
two of conftest's virtual CPU devices: each step's losses and per-leaf
gradients (JAX's: `value_and_grad` of the mean over the ranks' block
losses with their keys) and the first update, by `check_step_vs_jax`'s
tolerances; after both steps the parameters and both steps' losses
against the JAX mesh step's (losses within 1e-3 of their magnitude, the
parameters within twice the largest learning rate for two Adam steps,
each of at most lr per element: a roundoff-level gradient may flip an
element's update sign). The two ranks end bit for bit equal. (The same
in per-block-frame mode: `test_torch_ddp_frames.py`.) A world of one
rank is bit-equal to mesh=None; a leaf whose gradient is None on one
rank is reduced as zeros there, without a hang; and the control plane's
collectives and `replicate_over_mesh` do what JAX's do."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_renderer import small_config
from torch_port_util import (check_step_vs_jax, jax_draws, jax_scene,
                             port_batch, port_cfg, port_params)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_mp_worker.py')
R = 32          # rays a block
WORKER_TIMEOUT = 240


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('ARAH_FORCE_PALLAS', None)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_worker(mode, case, tmp, nprocs=None):
    """The worker's outputs, one dict a rank; nprocs None: one process
    outside any group. A rank that fails or hangs fails the test (every
    rank is killed at WORKER_TIMEOUT seconds)."""
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, 'case.pt')
    torch.save(case, path)
    port = _free_port()
    ranks = [None] if nprocs is None else range(nprocs)
    procs = []
    for r in ranks:
        cmd = [sys.executable, WORKER, mode, path, str(tmp)]
        if r is not None:
            cmd += ['--rank', str(r), '--nprocs', str(nprocs),
                    '--coordinator', f'127.0.0.1:{port}']
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=_env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    fail = []
    for r, p in zip(ranks, procs):
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            fail.append(f'--- rank {r} (rc={p.returncode}) ---\n'
                        + out.decode(errors='replace')[-4000:])
    assert not fail, '\n'.join(fail)
    return [torch.load(os.path.join(tmp, f'rank{r or 0}.pt'),
                       weights_only=False) for r in ranks]


def _scene(n_blocks, per_block_frame):
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.train.loss import LossWeights
    cfg = small_config(train_skinning=True)
    rng = np.random.RandomState(0)
    model, params, fd, _ = jax_scene(cfg, rng, n_rays=8)
    fds = None
    if per_block_frame:
        from arah_tpu.model import prepare_frame
        fds = [prepare_frame(
            model, jnp.asarray((rng.randn(10) * 0.3).astype(np.float32)),
            jnp.asarray((rng.randn(72) * 0.2).astype(np.float32)),
            jnp.asarray([0.1, 0.0, 0.2], jnp.float32))
            for _ in range(n_blocks)]
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fd,
                                  n_blocks=n_blocks, n_rays=R, n_reg=64,
                                  fds=fds)
    if per_block_frame:
        batch = batch._replace(latent_idx=jnp.asarray(
            np.arange(n_blocks) % 2, jnp.int32))
    return cfg, params, batch, LossWeights(n_ray_loss=R)


def _jax_grads(cfg, batch, loss_w, n_ranks, pbf):
    """A jitted (params, key) -> (losses, grads) of the mean over ranks r
    and their blocks b of `_block_loss` with key split(fold_in(key, r),
    blocks a rank)[b]: the gradient JAX's sharded step averages."""
    from arah_tpu.parallel.train_step import _block_loss
    k = batch.ray_dirs.shape[0] // n_ranks

    def loss_fn(p, key):
        ls = []
        for r in range(n_ranks):
            keys = jax.random.split(jax.random.fold_in(key, r), k)
            for b in range(k):
                g = r * k + b
                idx = batch.latent_idx[g] if pbf else batch.latent_idx
                ls.append(_block_loss(p, cfg, loss_w, batch, p['latent'][idx],
                                      g, keys[b], per_block_frame=pbf))
        ls = jax.tree.map(lambda *xs: jnp.mean(jnp.stack(xs)), *ls)
        return ls['loss'], ls
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def grads(params, key):
        (_, losses), g = vg(params, key)
        return losses, g
    return grads


def _jax_mesh_steps(cfg, params, batch, loss_w, keys, pbf):
    """States and losses of JAX's sharded step over a 2-device mesh."""
    from arah_tpu.parallel.mesh import block_sharding, make_mesh, replicated
    from arah_tpu.parallel.train_step import (N_PER_BLOCK_FIELDS,
                                              TrainState, make_train_step)
    from arah_tpu.train.optim import OptimConfig, make_optimizer
    mesh = make_mesh(2)
    bs, rep = block_sharding(mesh), replicated(mesh)
    fs = bs if pbf else rep
    batch = batch._replace(
        **{f: jax.device_put(getattr(batch, f), bs)
           for f in batch._fields[:N_PER_BLOCK_FIELDS]},
        frame=jax.device_put(batch.frame, fs),
        latent_idx=jax.device_put(batch.latent_idx, fs))
    opt, _ = make_optimizer(OptimConfig(train_skinning_net=True), params)
    state = jax.device_put(
        TrainState(params, opt.init(params), jnp.int32(0)), rep)
    step = make_train_step(cfg, loss_w, opt, mesh=mesh, donate=False,
                           per_block_frame=pbf)
    out = []
    for key in keys:
        state, losses = step(state, batch, key)
        out.append((jax.tree.map(np.asarray, state.params),
                    {k: float(v) for k, v in losses.items()}))
    return out


def _case(cfg, params, batch, loss_w, keys, n_ranks, pbf):
    from arah_tpu_torch.train.loss import LossWeights
    k = batch.ray_dirs.shape[0] // n_ranks
    return {'cfg': port_cfg(cfg), 'loss_w': LossWeights(**loss_w._asdict()),
            'params': port_params(params), 'batch': port_batch(batch),
            'per_block_frame': pbf,
            'draws': [[jax_draws(cfg, jax.random.fold_in(key, r), k, R)
                       for r in range(n_ranks)] for key in keys]}


def _port_tree(template, step):
    """A step's parameters from the worker as the port's tree, their
    `.grad` the step's gradients."""
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    tree = port_params(template)
    for path, leaf in tree_leaves_with_path(tree):
        leaf.data = step['params'][path]
        leaf.grad = step['grads'][path]
    return tree


def _close(a, b):
    return abs(a - b) <= 1e-3 * max(abs(a), abs(b)) + 1e-6


def _check_ddp(tmp_path, pbf):
    from arah_tpu.train.optim import OptimConfig
    from arah_tpu_torch.train.optim import (make_optimizer,
                                            tree_leaves_with_path)
    cfg, params, batch, loss_w = _scene(2, pbf)
    keys = [jax.random.PRNGKey(2), jax.random.PRNGKey(3)]
    out = run_worker('step', _case(cfg, params, batch, loss_w, keys, 2, pbf),
                     tmp_path, nprocs=2)
    # the ranks' replicas are bit for bit equal after every step
    for s0, s1 in zip(*out):
        assert s0['losses'] == s1['losses']
        for path, a in s0['params'].items():
            assert torch.equal(a, s1['params'][path]), path
    steps = out[0]

    jmesh = _jax_mesh_steps(cfg, params, batch, loss_w, keys, pbf)
    jax_grads = _jax_grads(cfg, batch, loss_w, 2, pbf)
    # step 1: losses, gradients and the update against JAX
    jl, jg = jax_grads(params, keys[0])
    pp = port_params(params)
    before = {p: l.detach().clone() for p, l in tree_leaves_with_path(pp)}
    _, labels = make_optimizer(OptimConfig(train_skinning_net=True), pp)
    check_step_vs_jax(jl, jg, jmesh[0][0], steps[0]['losses'],
                      _port_tree(params, steps[0]), before, labels)
    # step 2: losses and gradients against JAX's at the port's step-1
    # parameters, by check_step_vs_jax's rules
    at = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jnp.asarray(v.numpy()) for v in steps[0]['params'].values()])
    jl2, jg2 = jax_grads(at, keys[1])
    for k, v in jl2.items():
        assert _close(steps[1]['losses'][k], float(v)), k
    worst = []
    for (_, g), (path, _) in zip(jax.tree_util.tree_leaves_with_path(jg2),
                                 tree_leaves_with_path(pp)):
        g = np.asarray(g)
        pg = steps[1]['grads'][path]
        pg = np.zeros_like(g) if pg is None else pg.numpy()
        scale = np.abs(g).max()
        if scale > 0:
            rel = np.abs(pg - g).max() / scale
            cos = float((pg * g).sum() / (np.linalg.norm(pg)
                                          * np.linalg.norm(g)))
            assert rel < 1e-2 and cos >= 0.999, (path, rel, cos)
            worst.append(rel)
        else:
            assert np.abs(pg).max() <= 1e-6, path
    assert float(np.median(worst)) < 1e-4, np.median(worst)
    # both steps against JAX's sharded step: its losses, and after two
    # steps every parameter within two Adam steps of the largest lr
    for (_, jlosses), st in zip(jmesh, steps):
        for k, v in jlosses.items():
            assert _close(st['losses'][k], v), k
    for (_, jv), (path, _) in zip(
            jax.tree_util.tree_leaves_with_path(jmesh[1][0]),
            tree_leaves_with_path(pp)):
        d = np.abs(steps[1]['params'][path].numpy() - np.asarray(jv))
        assert d.max() <= 2 * 2 * 1e-4 + 1e-6, (path, d.max())


def test_two_ranks_vs_jax_mesh(tmp_path):
    _check_ddp(tmp_path, pbf=False)


def test_world_of_one_bit_equal_to_no_mesh(tmp_path):
    cfg, params, batch, loss_w = _scene(2, False)
    case = _case(cfg, params, batch, loss_w,
                 [jax.random.PRNGKey(2), jax.random.PRNGKey(3)], 1, False)
    one = run_worker('step', case, tmp_path / 'mesh', nprocs=1)[0]
    none = run_worker('step', case, tmp_path / 'none')[0]
    for a, b in zip(one, none):
        assert a['losses'] == b['losses']
        for path, g in b['grads'].items():
            if g is not None:
                assert torch.equal(a['grads'][path], g), path
        for path, v in b['params'].items():
            assert torch.equal(a['params'][path], v), path


def test_none_grad_on_one_rank_reduces(tmp_path):
    """Rank 1 holds no gradient for leaf 1 (a leaf its blocks did not
    reach); both ranks reduce the same buffer and get rank 0's gradient
    over 2 there, the mean elsewhere."""
    rng = np.random.RandomState(0)
    leaves = [torch.zeros(3, 4), torch.zeros(5), torch.zeros(2, 2)]
    g = [[torch.as_tensor(rng.randn(*l.shape).astype(np.float32))
          for l in leaves] for _ in range(2)]
    g[1][1] = None
    out = run_worker('reduce', {'leaves': leaves, 'grads': g}, tmp_path,
                     nprocs=2)
    for o in out:
        assert o['loss'] == 0.5
        for i, a in enumerate(o['grads']):
            want = g[0][i] / 2 if g[1][i] is None else (g[0][i] + g[1][i]) / 2
            torch.testing.assert_close(a, want, rtol=0, atol=1e-7)
    for a, b in zip(out[0]['grads'], out[1]['grads']):
        assert torch.equal(a, b)


def test_control_plane_and_replicate(tmp_path):
    """`gather_metrics` (the mean over ranks), `broadcast_one_to_all`
    (rank 0's stop flag), `process_allgather` (rows in rank order) and
    `replicate_over_mesh` (rank 0's parameters and Adam moments on both
    ranks, as DDP starts) over two gloo ranks."""
    leaves = [torch.zeros(3)]
    g = [[torch.ones(3)], [torch.ones(3) * 3]]
    out = run_worker('reduce', {'leaves': leaves, 'grads': g}, tmp_path,
                     nprocs=2)
    for r, o in enumerate(out):
        assert o['metrics'] == {'psnr': 20.5, 'ssim': 0.125}
        assert o['stop'] is True
        np.testing.assert_array_equal(
            o['rows'], np.stack([np.zeros((2, 3)), np.ones((2, 3))]))
        for k in ('w', 'latent'):
            assert torch.equal(o['params'][k], out[0]['params'][k])
        assert len(o['adam']) == 2
        for a, b in zip(o['adam'], out[0]['adam']):
            for k in a:
                assert torch.equal(a[k], b[k]), k
    # rank 0's own values, not a mean: its Adam moments saw gradient 1
    assert float(out[1]['adam'][0]['exp_avg'].max()) == \
        pytest.approx(0.1)
