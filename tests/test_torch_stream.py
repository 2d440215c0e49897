"""The Python side of the port's kernels on `csrc/stream_mlp.cuh` (B and
L, the corr body; J, the standalone SIREN), on the CPU: a wrapper given
its pack (`packed=`) computes what it computes without one, and the
tracer's pack reaches B holding `pack_corr`'s skinning blocks; the
launch wrappers refuse, with ValueError and before touching the card, a
network that a launch shape does not take, and pick the corr shape by
the skinning MLP's width; the launch-shape tables of the wrappers are
the shapes the CUDA sources build; and the tile-waste count of the corr
bench (`utils/bench_corr.py:tile_waste`) on a hand-made count vector;
and the launch shapes of kernels A and K (`ops/knn.py`): their table
against csrc/knn.cu, the thresholds that pick them, and the refusal of
a shape the source does not build; and the text each ablation of that
body in `chip_smoke.py` replaces."""
import os
import re

import numpy as np
import pytest
import torch

from torch_port_util import port_gen, t
from test_torch_kernels import _small_gen

torch.set_num_threads(2)


def _skin(rng, dims=(3, 32, 32, 25)):
    ws = [t(rng.randn(o, i).astype(np.float32) / np.sqrt(i))
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [t(rng.randn(o).astype(np.float32) * 0.1) for o in dims[1:]]
    return ws, bs


def _corr_problem(rng, n=48):
    from arah_tpu_torch.core.smpl import batch_rodrigues
    aa = torch.as_tensor((rng.randn(24, 3) * 0.15).astype(np.float32))
    tfs = torch.eye(4).repeat(24, 1, 1)
    tfs[:, :3, :3] = batch_rodrigues(aa)
    tfs[:, :3, 3] = t(rng.randn(24, 3) * 0.05)
    x0 = t(rng.randn(n, 3) * 0.3)
    x_bar = x0 + t(rng.randn(n, 3) * 0.03)
    T0 = tfs[rng.randint(0, 24, n)].reshape(n, 16).contiguous()
    mask = torch.as_tensor(rng.rand(n) > 0.2)
    return (x_bar, x0, T0, mask), (tfs.reshape(24, 16), t(-1.1), t(1.0),
                                   t(rng.randn(3) * 0.05))


def _skin_view(packed):
    """What the corr kernel reads of a pack: the skinning NetMeta fields
    and, per layer, the (in, pad32(out)) weight block and padded bias."""
    meta, params, n = packed.meta, packed.params, packed.meta.n_skin
    dims = list(meta.skin_dims)[:n + 1]
    blocks = []
    for l in range(n):
        op = -(-dims[l + 1] // 32) * 32
        wo, bo = meta.skin_wt_off[l], meta.skin_b_off[l]
        blocks += [params[wo:wo + dims[l] * op], params[bo:bo + op]]
    return n, dims, blocks


@pytest.mark.parametrize('wrapper', ['corr_search', 'corr_search_rows',
                                     'siren_sdf'])
def test_packed_argument_changes_nothing_on_the_cpu(rng, wrapper, monkeypatch):
    """`packed=` (the pack the tracer or `make_fused_sdf_fn` builds once)
    gives, on CPU tensors, exactly the values of the call without it (the
    CPU path computes the plain version and reads no pack). What the pack
    must be is held where it is made: the tracer's `trace_pack` reaches
    both launches of B's straggler split unchanged, and holds the very
    skinning blocks and NetMeta fields of `pack_corr`, with a SIREN beside
    them (B) or alone (no SIREN: the pack L's wrapper makes itself)."""
    if wrapper == 'siren_sdf':
        from arah_tpu_torch.ops.siren import pack_siren_sdf, siren_sdf
        gen = port_gen(_small_gen(rng, True))
        x = t(rng.rand(40, 3) * 2 - 1)
        a, b = siren_sdf(gen, x), siren_sdf(gen, x, pack_siren_sdf(gen))
        assert torch.equal(a, b)
        return
    from arah_tpu_torch.ops.corr import corr_search, dense_skin_fn, pack_corr
    from arah_tpu_torch.ops.corr_rows import corr_search_rows
    from arah_tpu_torch.render import ray_tracing as rt
    from arah_tpu_torch.solver.root_find import CanonicalFrame
    ws, bs = _skin(rng)
    pts, frame = _corr_problem(rng)
    cfg = rt.RayTracerConfig(use_pallas_march=False, use_pallas_iso=False,
                             use_pallas_corr=True, corr_phase1_steps=2,
                             corr_max_steps=6)
    gen = port_gen(_small_gen(rng, True)) if wrapper == 'corr_search' \
        else None
    packed = rt.trace_pack(cfg, gen, (ws, bs, 20.0))
    wt = [w.T for w in ws]          # L's (in, out) weights
    own = pack_corr(ws if gen is not None else [w.T for w in wt], bs)
    n, dims, blocks = _skin_view(packed)
    n_o, dims_o, blocks_o = _skin_view(own)
    assert (n, dims) == (n_o, dims_o) == (3, [3, 32, 32, 25])
    assert all(torch.equal(u, v) for u, v in zip(blocks, blocks_o))
    assert (packed.meta.n_layers > 1) == (gen is not None)
    if gen is None:
        assert torch.equal(packed.params, own.params)
        assert bytes(packed.meta) == bytes(own.meta)
        a = corr_search_rows(*pts, wt, bs, *frame, max_steps=6)
        b = corr_search_rows(*pts, wt, bs, *frame, max_steps=6,
                             packed=packed)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        assert bool(a[2].any())
        return
    seen = []

    def spy(*args, **kw):
        seen.append(kw['packed'])
        out = corr_search(*args, **kw)
        ref = corr_search(*args, **dict(kw, packed=None))
        assert all(torch.equal(u, v) for u, v in zip(out, ref))
        return out
    monkeypatch.setattr(rt, 'corr_search', spy)
    x_bar, x0, T0, mask = pts
    bones16, cmin, cmax, center = frame
    cf = CanonicalFrame(bones16.reshape(24, 4, 4), torch.zeros(3), cmin,
                        cmax, center)
    x, _, v, _, _ = rt._corr_solve_split(
        cfg, dense_skin_fn(ws, bs, 20.0), cf, (ws, bs, 20.0), x_bar, x0,
        T0.reshape(-1, 4, 4), mask, packed=packed)
    assert len(seen) == 2 and all(q is packed for q in seen)
    assert bool(v.any()) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize('case', ['corr_layer_160', 'corr_layer_288',
                                  'corr_no_skin', 'corr_shape_index',
                                  'siren_hidden_96_on_a_cluster',
                                  'siren_shape_index'])
def test_launch_wrappers_refuse_shapes_the_kernels_do_not_take(rng, case):
    """A corr pass wider than its launch shape takes (a 160-wide skinning
    layer at shape 0, which takes 128; a 288-wide one already at packing,
    wider than every shape's 256), a pack without a skinning MLP, a SIREN
    whose width (96) does not split into whole warps over the CTAs of J's
    cluster shape, and a launch-shape index the kernels do not have all
    raise ValueError on the CPU, before any tensor's device is looked
    at."""
    from arah_tpu_torch.ops import corr, siren
    pts, frame = _corr_problem(rng, 8)
    if case.startswith('corr'):
        dims = {'corr_layer_160': (3, 160, 25),
                'corr_layer_288': (3, 288, 25)}.get(case, (3, 32, 25))
        with pytest.raises(ValueError, match='launch shape|no skinning MLP'
                           '|unsupported skinning MLP'):
            packed = corr.pack_corr(*_skin(rng, dims))
            if case == 'corr_no_skin':
                packed = packed._replace(meta=type(packed.meta)())
            corr.launch_corr('corr', *pts, packed, *frame, 4, 1e-5, 20.0,
                             True, shape={'corr_shape_index': len(corr.SHAPES),
                                          'corr_layer_160': 0}.get(case))
        return
    from arah_tpu_torch.nn.siren import GeneratedMLP
    H = 96
    dims = [(H, 3), (H, H), (H, H), (1, H)]
    gen = GeneratedMLP(tuple(t(rng.randn(*d) * 0.1) for d in dims),
                       tuple(t(rng.randn(d[0]) * 0.1) for d in dims), (), ())
    x = t(rng.rand(8, 3))
    shape = len(siren.SHAPES) if case == 'siren_shape_index' else next(
        i for i, (c, _) in enumerate(siren.SHAPES) if H % (32 * c))
    with pytest.raises(ValueError, match='launch shape'):
        siren.launch_siren(x, siren.pack_siren_sdf(gen), 1, shape)


@pytest.mark.parametrize('width', [128, 160, 256])
def test_corr_launch_shape_follows_the_skinning_width(rng, width):
    """The corr kernel takes a collapsed skinning MLP up to 256 wide, as
    kernel F does: layers at most 128 wide (the flagship's) take shape 0
    above 4,096 points and the cluster shape 1 below; a wider one takes
    the 256-wide shape 2 at every batch size, which `check_pass` accepts
    and the 128-wide shapes refuse."""
    from arah_tpu_torch.ops import corr
    from arah_tpu_torch.ops.march import check_pass, pass_widths
    packed = corr.pack_corr(*_skin(rng, (3, width, width, 25)))
    widest = max(pass_widths(packed.meta, True, False))
    assert widest == width
    picks = [corr.launch_shape(n, widest) for n in (1, 4096, 4097, 524288)]
    assert picks == ([1, 1, 0, 0] if width <= 128 else [2] * 4)
    for shape, (_, maxw) in enumerate(corr.SHAPES):
        if maxw >= width:
            check_pass('corr', packed.meta, corr.SHAPES, shape, True, False)
        else:
            with pytest.raises(ValueError, match='launch shape'):
                check_pass('corr', packed.meta, corr.SHAPES, shape, True,
                           False)
    assert all(check_pass('corr', packed.meta, corr.SHAPES, p, True, False)
               is None for p in set(picks))


def _c_shapes(src, prefix):
    """[(cluster, widest layer)] of the `using <prefix>N = TileShape<R, NT,
    C, KC, MINB, ST[, MAXW]>` lines of a csrc file, N = 0, 1, ... in
    order, and the dispatch's `case N:` lines naming them."""
    from arah_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, src)) as fh:
        text = fh.read()
    rows = re.findall(r'using\s+' + prefix + r'(\d+)\s*=\s*TileShape<([^>]*)>',
                      text)
    assert [int(i) for i, _ in rows] == list(range(len(rows)))
    cases = re.findall(r'case\s+(\d+):\s*return\s+\w+<' + prefix + r'(\d+)>',
                       text)
    assert cases == [(str(i), str(i)) for i in range(len(rows))], cases
    out = []
    for _, args in rows:
        a = [int(v) for v in args.split(',')]
        out.append((a[2], a[6] if len(a) > 6 else 256))
    return out


@pytest.mark.parametrize('kernel', ['corr', 'siren'])
def test_launch_shape_tables_match_the_sources(kernel):
    """`ops/corr.py:SHAPES` and `ops/siren.py:SHAPES` (what the Python
    checks hold a network against) are the (cluster size, widest layer)
    of the shapes csrc/corr_rows.cu and csrc/siren.cu build, in the order
    of their dispatch; `launch_shape` picks a shape they have for every
    batch size."""
    from arah_tpu_torch.ops import corr, siren
    mod, src, prefix = {'corr': (corr, 'corr_rows.cu', 'CorrShape'),
                        'siren': (siren, 'siren.cu', 'SirenShape')}[kernel]
    assert list(mod.SHAPES) == _c_shapes(src, prefix)
    for n in (1, 256, 1024, 2048, 2049, 4096, 4097, 524288):
        assert 0 <= mod.launch_shape(n) < len(mod.SHAPES)


def test_tile_waste_counts_a_hand_made_vector():
    """Tiles of 4: [0, 3, 1, masked] run 4 x (1 + 3), [2, 2, 2, 2] 4 x 3,
    [masked, 0] (padded) 4 x 1: 32 evaluations for the 20 the unmasked
    points need (1 + iterations each)."""
    from arah_tpu_torch.utils.bench_corr import tile_waste
    iters = torch.tensor([0, 3, 1, 5, 2, 2, 2, 2, 7, 0], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 0, 1, 1, 1, 1, 0, 1], dtype=torch.bool)
    assert tile_waste(iters, mask, tile=4) == (32, 20)
    assert tile_waste(iters, torch.ones_like(mask), tile=16) == (16 * 8, 34)


def _knn_c_shapes():
    """[(threads, points a thread, vertex groups, cluster)] of the
    `using KnnShapeN = KnnShape<NT, P, W, C, MINB>` lines of
    csrc/knn.cu, N = 0, 1, ... in order, and the dispatch's `case N:`
    lines naming them."""
    from arah_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, 'knn.cu')) as fh:
        text = fh.read()
    rows = re.findall(r'using\s+KnnShape(\d+)\s*=\s*KnnShape<([^>]*)>', text)
    assert [int(i) for i, _ in rows] == list(range(len(rows)))
    cases = re.findall(r'case\s+(\d+):\s*return\s+knn_launch<KnnShape(\d+)>',
                       text)
    assert cases == [(str(i), str(i)) for i in range(len(rows))], cases
    out = []
    for _, args in rows:
        a = [int(v) for v in args.split(',')]
        assert len(a) == 5, args
        out.append(tuple(a[:4]))
    return out


def test_knn_launch_shapes_match_the_source():
    """`ops/knn.py:SHAPES` (what kernels A and K launch, and what the
    sweep reports) are the shapes csrc/knn.cu builds, in the order of its
    dispatch, each of whole-warp vertex groups."""
    from arah_tpu_torch.ops import knn
    assert list(knn.SHAPES) == _knn_c_shapes()
    for nt, p, w, c in knn.SHAPES:
        assert nt % w == 0 and (nt // w) % 32 == 0 and p >= 1
        assert c in (1, 2, 4, 8)


@pytest.mark.parametrize('n,shape', [(0, 2), (1, 2), (256, 2), (1024, 2),
                                     (4096, 2), (4097, 1), (8192, 1),
                                     (196608, 1), (196609, 0), (524288, 0)])
def test_knn_launch_shape_thresholds(n, shape):
    """Kernels A and K take the clusters of 4 up to 4,096 points (the
    plain loops' phase-2 batches of <= 1,024), the clusters of 2 up to
    196,608 (the plain march's 8,192), and the wide shape above (the corr
    init's 524,288)."""
    from arah_tpu_torch.ops import knn
    assert knn.launch_shape(n) == shape
    assert 0 <= shape < len(knn.SHAPES)


@pytest.mark.parametrize('shape', [-1, 3, 99])
def test_knn_unknown_launch_shape_raises(rng, shape):
    """A launch shape csrc/knn.cu does not build raises ValueError, before
    any tensor's device is looked at (no fallback to another shape or to
    the plain version)."""
    from arah_tpu_torch.ops import knn
    assert shape < 0 or shape >= len(knn.SHAPES)
    p, v = t(rng.randn(8, 3)), t(rng.randn(5, 3))
    with pytest.raises(ValueError, match='no launch shape'):
        knn.launch_knn(p, v, shape)
    with pytest.raises(ValueError, match='no launch shape'):
        knn.knn_shape(shape, 8, 5)
    with pytest.raises(ValueError, match='expected a CUDA tensor'):
        knn.launch_knn(p, v, 0)


@pytest.mark.parametrize('name', ['select', 'undoubled', 'no rescan',
                                  'no scan', 'staging only', 'launch only'])
def test_knn_ablations_apply_to_the_source(name):
    """Each ablation `chip_smoke.py` builds of A/K's body is csrc/knn.cu
    with text replaced that appears there exactly once, so an edit of the
    body cannot leave an ablation timing the body unchanged."""
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(root, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from arah_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, 'knn.cu')) as fh:
        text = fh.read()
    subs = smoke.KNN_ABLATIONS[name]
    src = smoke.knn_ablation_source(subs)
    assert src != text
    for old, new in subs:
        assert text.count(old) == 1 and new in src
    with pytest.raises(ValueError, match='appears 0 times'):
        smoke.knn_ablation_source(subs + [('no such text', '')])
