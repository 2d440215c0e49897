"""The yardstick's arithmetic against hand-worked values: the window of
whole passes, the idle share and the kernel families of a synthetic
trace, the least times behind the roofline and `image_mfu`, the depth
check, and `correct` as the conjunction of the printed checks."""
import importlib.util
import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import pytest

import numpy as np

from gpubench import flops
from gpubench.devtrace import summarize
from gpubench.harness import Check, Outcome, closed_loop, emit, verdict
from gpubench.kinds.render import compare

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIREN = [(256, 3)] + [(256, 256)] * 5 + [(1, 256)]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        'm', os.path.join(HERE, 'metrics', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel(name, ts, dur):
    return {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': ts, 'dur': dur}


def host(name, ts, dur):
    return {'ph': 'X', 'cat': 'cpu_op', 'name': name, 'ts': ts, 'dur': dur}


EVENTS = [
    kernel('void shade_bwd_kernel<true>(float const*)', 0, 10),
    kernel('void atb_kernel<64>(float const*)', 5, 10),
    host('aten::nonzero', 14, 8),
    host('aten::index', 16, 2),
    kernel('color_bwd_kernel', 20, 4),
    kernel('atb_sum', 24, 6),
    kernel('void march_kernel<S0>(MarchArgs)', 32, 2),
    kernel('outside', 50, 5),          # beyond the window: left out
]


@pytest.mark.parametrize('multiple', [1, 3, 8])
def test_the_window_ends_on_whole_passes(multiple):
    times, outs, window_s, summary = closed_loop(lambda i: i, 0.0,
                                                 multiple=multiple)
    assert outs == list(range(multiple))
    assert len(times) == multiple and summary is None
    assert window_s == pytest.approx(sum(times))


def test_the_trace_reading_is_no_units_time(monkeypatch):
    import contextlib
    import time
    from gpubench import devtrace

    class SlowTracer:
        summary = 'read'

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            time.sleep(0.3)          # the export and reduction
            return False
    monkeypatch.setattr(devtrace, 'Tracer', SlowTracer)
    monkeypatch.setattr(devtrace, 'window', contextlib.nullcontext)
    times, outs, window_s, summary = closed_loop(
        lambda i: i, 0.0, trace_units=1, multiple=4)
    assert summary == 'read' and outs == [0, 1, 2, 3]
    assert max(times) < 0.1
    # the window's own length still holds all of it
    assert window_s >= 0.3


def test_summary_of_a_synthetic_trace():
    s = summarize(EVENTS, 0.0, 40.0)
    assert s.window_s == pytest.approx(40e-6)
    # [0, 15] + [20, 30] + [32, 34]
    assert s.busy_s == pytest.approx(27e-6)
    assert s.launches == 5
    # atb kernels count to the H or I launch before them
    assert s.family_s['H'] == pytest.approx(20e-6)
    assert s.family_s['I'] == pytest.approx(10e-6)
    assert s.family_s['E'] == pytest.approx(2e-6)
    # the longest gaps first, each named by the innermost host op
    # running when it began
    assert [g[0] for g in s.idle_gaps] == ['(no host op)', 'aten::nonzero',
                                          '(no host op)']
    assert [g[1] for g in s.idle_gaps] == pytest.approx([6e-6, 5e-6, 2e-6])
    assert s.top_ops[0][0].startswith('void shade_bwd_kernel')


def test_readers():
    s = summarize(EVENTS, 0.0, 40.0)
    render = {'kind': 'render', 'trace': s, 'units': 2, 'rays': 2000,
              'least_s': {'C': 1e-6, 'images': 0.3}, 'images_s': 10.0}
    assert reader('device_idle_share.render')(render) == \
        pytest.approx(100 * 13 / 40)
    assert reader('device_idle_share.render')({'kind': 'render'}) is None
    assert reader('image_mfu.render')(render) == pytest.approx(3.0)
    assert reader('launches_per_kray.render')(render) == 2.5
    assert reader('tracer_ms_per_kray.render')(render) == \
        pytest.approx(1e-3)
    # no C launch traced: nothing to read, not 0
    assert reader('C_roofline.render')(render) is None


def test_flop_formulas():
    assert flops.mlp_fwd_flops(SIREN) == 657408
    assert flops.siren_shade_fwd_flops(SIREN) == 657408 + 656896
    n = 1000
    fwd_hidden = 2 * 5 * 2 * 256 * 256
    assert flops.shade_fwd_least_s(SIREN, n, True) == pytest.approx(
        n * fwd_hidden / 989e12
        + n * (flops.siren_shade_fwd_flops(SIREN) - fwd_hidden) / 67e12)
    assert flops.shade_fwd_least_s(SIREN, n, False) == pytest.approx(
        n * flops.siren_shade_fwd_flops(SIREN) / 67e12)
    # C at these sizes: its operations, not its bytes
    assert flops.c_least_s(SIREN, n, True) == pytest.approx(
        flops.shade_fwd_least_s(SIREN, n, True))
    color = [(256, 417), (256, 256), (128, 256), (256, 545), (256, 256),
             (3, 256)]
    body = 2 * (256 * 417 + 65536 + 32768 + 256 * 545 + 65536)
    assert flops.color_layers_least_s(color, n, 1, True) == pytest.approx(
        n * body / 989e12 + n * 2 * 3 * 256 / 67e12)


def test_image_least_time_blocks():
    out = flops.image_least_s(
        n_rays=8192, n_samples=64, n_verts=6890, siren_shapes=SIREN,
        skin_shapes=[(128, 3)] + [(128, 128)] * 3 + [(25, 128)],
        color_shapes=[(256, 417), (3, 256)], hypernet_params=1000,
        bf16=True)
    assert out['total'] == pytest.approx(sum(out['blocks'].values()))
    N = 8192 * 64
    assert out['blocks']['shade_fwd'] == pytest.approx(
        flops.shade_fwd_least_s(SIREN, N, True))
    # the forward alone: one product a colour layer, no backward blocks
    assert out['blocks']['color'] == pytest.approx(
        N * 2 * 256 * 417 / 989e12 + N * 2 * 3 * 256 / 67e12)
    assert 'shade_bwd' not in out['blocks']


def test_image_least_time_charges_one_evaluation_a_solver():
    skin_shapes = [(128, 3)] + [(128, 128)] * 3 + [(25, 128)]
    out = flops.image_least_s(
        n_rays=8192, n_samples=64, n_verts=6890, siren_shapes=SIREN,
        skin_shapes=skin_shapes, color_shapes=[(256, 417), (3, 256)],
        hypernet_params=1000, bf16=True)
    N = 8192 * 64
    skin = 2 * (384 + 3 * 16384 + 3200)
    assert out['blocks']['corr_loop'] == pytest.approx(
        N * (skin + 768) / 67e12)
    assert out['blocks']['hypernet'] == pytest.approx(2000 / 67e12)


def test_the_depth_check_sees_a_minority_of_moved_roots():
    n = 3000
    hit = np.ones(n, bool)
    depth = np.linspace(2.0, 3.0, n).astype(np.float32)
    rgb = np.zeros((n, 3), np.float32)
    moved = depth.copy()
    moved[::3] += 5e-3           # a third of the roots, 5 mm along
    got = compare((rgb, None, moved, hit), (rgb, depth, hit), 0.05, 1e-4)
    # the median gap of the old check would read 0
    assert float(np.median(np.abs(moved - depth))) == 0.0
    assert got['depth_far_share'] == pytest.approx(1 / 3)
    assert got['hit_disagree'] == 0.0 and got['rgb_far_share'] == 0.0
    # rays only one side hits are the hit check's, not the depth's
    r_hit = hit.copy()
    r_hit[::3] = False
    got = compare((rgb, None, moved, hit), (rgb, depth, r_hit), 0.05, 1e-4)
    assert got['depth_far_share'] == 0.0
    assert got['hit_disagree'] == pytest.approx(1 / 3)
    # a depth that is not a number is far
    nan = depth.copy()
    nan[0] = np.nan
    got = compare((rgb, None, nan, hit), (rgb, depth, hit), 0.05, 1e-4)
    assert got['depth_far_share'] == pytest.approx(1 / n)


@pytest.mark.parametrize('values,expected', [
    ((0.1, 0.2, 3), True),
    ((0.1, 0.3, 3), False),          # a gap over its limit
    ((float('nan'), 0.2, 3), False),  # a value that is not a number
    ((0.1, 0.2, 0), False),          # a 'min' check under its limit
])
def test_correct_is_the_conjunction_of_the_printed_checks(values, expected):
    checks = [Check('a', values[0], 0.2), Check('b', values[1], 0.2),
              Check('n', values[2], 1, 'min')]
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        got = emit(Outcome({}, {}, checks, 1, 0, 0), {}, {})
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert got == line['correct'] == verdict(checks) == expected
    assert list(line)[-1] == 'checks'
    printed = line['checks']
    assert set(printed) == {'a', 'b', 'n'}
    assert all((v['value'] is not None and (
        v['value'] <= v['limit'] if v['rule'] == 'max'
        else v['value'] >= v['limit'])) for v in printed.values()) \
        == expected
    assert err.getvalue().strip().splitlines()[-1] == f'correct: {expected}'


def test_no_checks_is_not_correct():
    assert verdict([]) is False
