"""One rank of the port's multi-process tests (`test_torch_ddp.py`,
`test_torch_dist_eval.py`, `test_torch_dist_cli.py`), on the CPU over
gloo. Imports torch and the port only; the tests make the inputs (from
the JAX package where they compare with it) and read the outputs.

    python tests/torch_mp_worker.py step|reduce|eval CASE OUT
        [--rank R --nprocs N --coordinator HOST:PORT]
    python tests/torch_mp_worker.py cli MODULE [argv ...]

step: `make_train_step(mesh=make_mesh())` (mesh=None without --nprocs)
on the rank's blocks of CASE's global batch, one step for each of CASE's
draws (a TrainDraws a rank); writes
OUT/rank<R>.pt with each step's losses, gradients and parameters after
it. reduce: `allreduce_mean` with CASE's leaf gradients, a
leaf's gradient None on rank 1. eval: `render_frame_rays(mesh=)`, and
the rank's own chunk slices rendered alone. cli: the CLI's `main(argv)`
(its flags join the group), with each dataset item drawn from a
generator seeded by its index, so that items do not depend on which
rank, thread or order draws them."""
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _flag(argv, name, default=None, cast=str):
    if name in argv:
        return cast(argv[argv.index(name) + 1])
    return default


def _join(argv):
    from arah_tpu_torch.parallel import distributed
    from arah_tpu_torch.parallel.mesh import make_mesh
    n = _flag(argv, '--nprocs', None, int)
    if n is None:
        return 0, None
    rank = _flag(argv, '--rank', 0, int)
    distributed.initialize(_flag(argv, '--coordinator'), n, rank,
                           backend='gloo', device='cpu')
    return rank, make_mesh()


def run_step(case, out, argv):
    from arah_tpu_torch.parallel.mesh import local_blocks
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            tree_leaves_with_path)
    rank, mesh = _join(argv)
    pbf = case['per_block_frame']
    pp = trainable(case['params'])
    opt, _ = make_optimizer(OptimConfig(train_skinning_net=True), pp)
    step = make_train_step(case['cfg'], case['loss_w'], opt, mesh=mesh,
                           per_block_frame=pbf)
    batch = case['batch'] if mesh is None else \
        local_blocks(case['batch'], rank, mesh.size, pbf)
    state = TrainState(pp, opt, 0)
    steps = []
    for draws in case['draws']:
        state, losses = step(state, batch, draws[rank])
        leaves = list(tree_leaves_with_path(pp))
        steps.append({
            'losses': {k: float(v) for k, v in losses.items()},
            'grads': {p: (None if leaf.grad is None else
                          leaf.grad.detach().clone()) for p, leaf in leaves},
            'params': {p: leaf.detach().clone() for p, leaf in leaves}})
    torch.save(steps, os.path.join(out, f'rank{rank}.pt'))


def run_reduce(case, out, argv):
    from arah_tpu_torch.parallel import distributed
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    allreduce_mean)
    from arah_tpu_torch.train.optim import OptimConfig, make_optimizer
    rank, mesh = _join(argv)
    leaves = [g.clone().requires_grad_(True) for g in case['leaves']]
    for leaf, g in zip(leaves, case['grads'][rank]):
        leaf.grad = None if g is None else g.clone()
    losses = allreduce_mean(leaves, {'loss': torch.tensor(float(rank))},
                            mesh)
    # the control plane, and DDP's start: rank 0's parameters and Adam
    # state on every rank
    params = {'color': {'w': torch.full((2, 3), float(rank))},
              'latent': torch.full((4, 2), 10.0 + rank)}
    opt, _ = make_optimizer(OptimConfig(), params)
    for p in (params['color']['w'], params['latent']):
        p.requires_grad_(True).grad = torch.ones_like(p) * (rank + 1)
    opt.step()
    distributed.replicate_over_mesh(TrainState(params, opt, 0), mesh)
    torch.save({'grads': [leaf.grad for leaf in leaves],
                'loss': float(losses['loss']),
                'metrics': distributed.gather_metrics(
                    {'psnr': 20.0 + rank, 'ssim': rank / 4}),
                'stop': bool(distributed.broadcast_one_to_all(rank == 0)),
                'rows': distributed.process_allgather(
                    np.full((2, 3), rank, np.float32)),
                'params': {k: v.detach() for k, v in
                           (('w', params['color']['w']),
                            ('latent', params['latent']))},
                'adam': [{k: v.clone() for k, v in st.items()}
                         for st in opt.adam.state.values()]},
               os.path.join(out, f'rank{rank}.pt'))
    distributed.sync_global_devices('done')


def run_eval(case, out, argv):
    from arah_tpu_torch.eval.evaluator import render_frame_rays
    rank, mesh = _join(argv)
    args = (case['params'], case['cfg'], case['fd'], case['item'],
            case['latent'])
    full = render_frame_rays(*args, chunk=case['chunk'], mesh=mesh)
    # the rank's rows of every chunk (rounded to the mesh, the last one
    # padded with its last ray), each rendered alone, at the same size
    chunk = case['chunk'] - case['chunk'] % mesh.size
    k = chunk // mesh.size
    padded = {key: np.pad(a, ((0, -len(a) % chunk), (0, 0)), mode='edge')
              for key, a in case['item'].items() if a.ndim == 2}
    rows, alone = [], []
    for i in range(0, len(case['item']['inputs.ray_dirs']), chunk):
        r = np.arange(i + rank * k, i + (rank + 1) * k)
        item = dict(case['item'], **{key: a[r] for key, a in padded.items()})
        rows.append(r)
        alone.append(render_frame_rays(*args[:3], item, args[4], chunk=k))
    rows = np.concatenate(rows)
    alone = [np.concatenate(parts) for parts in zip(*alone)]
    torch.save({'full': full, 'alone': alone, 'rows': rows},
               os.path.join(out, f'rank{rank}.pt'))


def run_cli(module, argv):
    import importlib
    from arah_tpu_torch.data import human_video
    for name in dir(human_video):
        cls = getattr(human_video, name)
        if isinstance(cls, type) and 'item' in vars(cls):
            _seed_items(cls)
    importlib.import_module(module).main(argv)


def _seed_items(cls):
    """Every item's draws (`item`, which `__getitem__` and the prefetcher
    call) from a generator seeded by the item's index."""
    item = cls.item

    def seeded(self, idx, rng=None):
        return item(self, idx, np.random.RandomState([7, int(idx)]))
    cls.item = seeded


def main():
    mode = sys.argv[1]
    if mode == 'cli':
        run_cli(sys.argv[2], sys.argv[3:])
        return
    case = torch.load(sys.argv[2], weights_only=False)
    out = sys.argv[3]
    {'step': run_step, 'reduce': run_reduce, 'eval': run_eval}[mode](
        case, out, sys.argv[4:])
    from arah_tpu_torch.parallel import distributed
    distributed.shutdown()


if __name__ == '__main__':
    main()
