"""Microbenchmark of the canonical-correspondence Broyden variants (port of
`bench_corr.py`).

    python -m arah_tpu_torch.utils.bench_corr [--n 262144] [--iters 5]
        [--variants dense,chunked,pallas,pallas_t_f32] [--cvg 1e-5] [--jac]

Solves fwd_skin(x_hat) = x_bar for n points of the JAX bench's synthetic
problem (`bench_corr.py:39-73`: a 128x4 skinning net, small random bone
transforms, targets skinned from N(0, 0.3^2) canonical points, inits 3 cm
off, 10% of the points masked), drawn from numpy seed 0 in the JAX
bench's order and casts, with the port's own skinning-net init (torch
seed 0): the frame, the inits and the mask equal the JAX bench's, the
targets and transforms do not (JAX draws the net from a PRNG key).
Variants:

  dense         `search_canonical_corr` over all points (plain);
  chunked       the same in 16,384-point chunks (plain);
  pallas        kernel L (`ops/corr_rows.py`, the row layout);
  pallas_t_f32  kernel B (`ops/corr.py`, f32);
  pallas_t      kernel B at precision 'split3' (the JAX bench's kernel
                variant, in its default set `dense,chunked,pallas_t`);
  pallas_t_bf16 kernel B at precision 'bf16' (give it `--cvg 5e-3`: its
                residual floors near 1e-3).

`--jac` has kernel B's variants write the Jacobian at each root too
(`want_jac`, the variants on launch shapes of their own at split3 and
bf16).

Prints ms per call (the host clock around synchronised calls, after one
warm-up) and the valid share of each variant, then each kernel variant's
agreement with the plain solve. Every variant uses `--cvg` (the JAX
bench passes it to the kernels only). Runs on the card unless `main` is
given `device='cpu'`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from arah_tpu_torch.core.body import normalize_canonical_points
from arah_tpu_torch.core.smpl import batch_rodrigues
from arah_tpu_torch.nn.skinning import (SkinningConfig, init_skinning,
                                        skinning_dense_params,
                                        skinning_weights)
from arah_tpu_torch.ops.corr import corr_search
from arah_tpu_torch.ops.corr_rows import corr_search_rows
from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                             forward_skinning,
                                             search_canonical_corr)

CHUNK = 16384
KERNEL_PRECISION = {'pallas_t_f32': 'f32', 'pallas_t': 'split3',
                    'pallas_t_bf16': 'bf16'}


def make_problem(n: int, device):
    """The JAX bench's problem at n points: (skin_fn, frame, x_bar, x0,
    T0 (n, 4, 4), mask, dense (out, in) weights, biases)."""
    rng = np.random.RandomState(0)
    cfg = SkinningConfig(d_hidden=128, n_layers=4)
    params = init_skinning(torch.Generator().manual_seed(0), cfg,
                           device=device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    aa = (rng.randn(24, 3) * 0.15).astype(np.float32)
    tfs = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    tfs[:, :3, :3] = batch_rodrigues(torch.as_tensor(aa)).numpy()
    tfs[:, :3, 3] = (rng.randn(24, 3) * 0.05).astype(np.float32)
    frame = CanonicalFrame(f32(tfs), f32(np.zeros(3)), f32(-1.1), f32(1.0),
                           f32(rng.randn(3).astype(np.float32) * 0.05))

    def skin_fn(x):
        return skinning_weights(params, cfg, x)
    x_gt = f32(rng.randn(n, 3).astype(np.float32) * 0.3)
    with torch.no_grad():
        x_bar, _ = forward_skinning(skin_fn, frame, x_gt)
        x0 = x_gt + 0.03 * f32(rng.randn(n, 3))
        w0 = skin_fn(normalize_canonical_points(
            x0, frame.coord_min, frame.coord_max, frame.center))
        T0 = torch.einsum('nj,jab->nab', w0, frame.bone_transforms)
    mask = torch.as_tensor(rng.rand(n) > 0.1, device=device)
    wts, bs = skinning_dense_params(params, cfg)
    return (skin_fn, frame, x_bar.contiguous(), x0.contiguous(), T0, mask,
            [w.detach() for w in wts], [b.detach() for b in bs])


def tile_waste(iters, mask, tile: int = 16):
    """(evaluations a tile kernel runs, evaluations the points need) of a
    corr solve whose points ran `iters` (N,) Broyden iterations: a tile
    of `tile` consecutive points (the last one padded) evaluates the
    skinning MLP at all its positions once at init and once an iteration
    until its slowest point stops; a point needs one evaluation at init
    and one an iteration, a masked point (`mask` False) none."""
    it = torch.where(mask, iters, torch.zeros_like(iters)).long()
    t = torch.nn.functional.pad(it, (0, -it.shape[0] % tile)) \
        .reshape(-1, tile)
    run = tile * int((1 + t.max(dim=1).values).sum()) if t.numel() else 0
    return run, int((1 + it)[mask].sum())


def main(argv=None, device=None) -> dict:
    """Run the bench; returns {variant: {'ms', 'x_hat', 'valid'} (and
    'iters', the Broyden iterations per point, for the plain ones)}."""
    p = argparse.ArgumentParser()
    p.add_argument('--n', type=int, default=262144)
    p.add_argument('--iters', type=int, default=5)
    p.add_argument('--variants', default='dense,chunked,pallas,pallas_t_f32')
    p.add_argument('--cvg', type=float, default=1e-5,
                   help='convergence threshold; 0 forces max_steps '
                        'iterations on every point (pure-speed A/B)')
    p.add_argument('--jac', action='store_true',
                   help="kernel B's variants with want_jac")
    args = p.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_corr: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        device = 'cuda'
    device = torch.device(device)
    variants = args.variants.split(',')
    unknown = sorted(set(variants) - {'dense', 'chunked', 'pallas'}
                     - set(KERNEL_PRECISION))
    if unknown:
        raise ValueError(f'bench_corr: unknown variants {unknown}')
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(args, variants, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _run(args, variants, device) -> dict:
    n, cvg = args.n, args.cvg
    skin_fn, frame, x_bar, x0, T0, mask, wts, bs = make_problem(n, device)
    T0_16 = T0.reshape(n, 16).contiguous()
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    box = (frame.coord_min, frame.coord_max, frame.center)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    def timeit(label, fn):
        out = fn()                 # warm-up (and the kernels' build)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn()
            sync()
        ms = (time.perf_counter() - t0) / max(args.iters, 1) * 1e3
        print(f'{label:28s} {ms:8.1f} ms   '
              f'valid={float(out["valid"].float().mean()):.3f}', flush=True)
        return dict(out, ms=ms)

    def plain(xb, xi, ti, m):
        r = search_canonical_corr(skin_fn, frame, xb, xi, ti,
                                  cvg_thresh=cvg, active_init=m)
        return dict(x_hat=r.x_hat, valid=r.valid & m, iters=r.iters)

    def chunked():
        parts = [plain(x_bar[s:s + CHUNK], x0[s:s + CHUNK], T0[s:s + CHUNK],
                       mask[s:s + CHUNK]) for s in range(0, n, CHUNK)]
        return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}

    def rows():
        x, _, v = corr_search_rows(x_bar, x0, T0_16, mask,
                                   [w.T for w in wts], bs, bones16, *box,
                                   cvg_thresh=cvg)
        return dict(x_hat=x, valid=v)

    def kernel_b(precision):
        out = corr_search(x_bar, x0, T0_16, mask, wts, bs, bones16, *box,
                          cvg_thresh=cvg, precision=precision,
                          want_jac=args.jac)
        return dict(x_hat=out[0], valid=out[2])

    results = {}
    with torch.no_grad():
        if 'dense' in variants:
            results['dense'] = timeit('dense (plain)',
                                      lambda: plain(x_bar, x0, T0, mask))
        if 'chunked' in variants:
            results['chunked'] = timeit(f'chunked (plain, {CHUNK})', chunked)
        if 'pallas' in variants:
            results['pallas'] = timeit('L corr_rows (row layout)', rows)
        for v, prec in KERNEL_PRECISION.items():
            if v in variants:
                results[v] = timeit(f'B corr {prec}'
                                    + (' jac' if args.jac else ''),
                                    lambda prec=prec: kernel_b(prec))
    ref = results.get('chunked') or results.get('dense')
    for name in ('pallas', *KERNEL_PRECISION):
        if ref is None or name not in results:
            continue
        out = results[name]
        both = ref['valid'] & out['valid']
        agree = float((ref['valid'] == out['valid']).float().mean())
        dx = torch.linalg.norm(out['x_hat'] - ref['x_hat'], dim=-1)[both]
        err = float(dx.max()) if dx.numel() else 0.0
        print(f'{name}: agreement={agree:.4f}  max|dx| on both-valid='
              f'{err:.2e}', flush=True)
    return results


if __name__ == '__main__':
    main()
