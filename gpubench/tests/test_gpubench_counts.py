"""The readers of the program's counters and the split of idle time over
the layers against hand-worked values: `layer_idle.split` on synthetic
traces (an idle interval cut across nested spans and span edges, idle
time under no span charged to `none`, the parts adding up to the idle
time, syncs counted inside the window only), `counts.b_least_s`, the
cell's configuration from the command line, and the three readers of
`counts.py` on counts given to them or on none."""
import importlib.util
import os
import sys

import pytest

from gpubench import counts, layer_idle
from gpubench.devtrace import TraceSummary

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZJU_SKIN = [3, 128, 128, 128, 128, 25]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        'm', os.path.join(HERE, 'metrics', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel(ts, dur):
    return {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': ts, 'dur': dur}


def span(name, ts, dur, cat='user_annotation'):
    return {'ph': 'X', 'cat': cat, 'name': 'arah.' + name, 'ts': ts,
            'dur': dur}


# kernels busy on [0, 10], [40, 50], [90, 100]; idle on [10, 40] and
# [50, 90] of the window [0, 100]
EVENTS = [
    kernel(0, 10), kernel(40, 10), kernel(90, 10),
    span('eval.chunk', 5, 90),
    span('renderer.render', 20, 40),
    span('tracer.corr.p1', 30, 15),
    span('tracer.sync.resolve', 55, 3),
    span('eval.sync.d2h', 96, 3),
    span('eval.sync.h2d', 101, 1),      # after the window [0, 100]
    span('renderer.shade', 12, 5, cat='gpu_user_annotation'),
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mul', 'ts': 70, 'dur': 5},
]


def test_idle_cut_at_nested_spans_and_edges():
    """[10, 40]: eval to 20, renderer to 30, the tracer's corr to 40;
    [50, 90]: renderer to 55, the tracer's sync to 58, renderer to 60
    (its edge), eval to 90. The device-side copy of a span and a host op
    that is no span take nothing."""
    out = layer_idle.split(EVENTS, 0.0, 100.0)
    assert out['layer_idle_s'] == pytest.approx(
        {'eval': 40e-6, 'renderer': 17e-6, 'tracer': 13e-6})
    assert out['window_s'] == pytest.approx(100e-6)
    assert out['busy_s'] == pytest.approx(30e-6)
    assert out['idle_s'] == pytest.approx(70e-6)


def test_idle_under_no_span_goes_to_none():
    """The window [0, 120]: after the last kernel, [100, 101] and
    [102, 120] lie under no span, [101, 102] under the image's copy."""
    out = layer_idle.split(EVENTS, 0.0, 120.0)
    parts = out['layer_idle_s']
    assert parts['none'] == pytest.approx(19e-6)
    assert parts['eval'] == pytest.approx(41e-6)
    assert parts == pytest.approx({'eval': 41e-6, 'renderer': 17e-6,
                                   'tracer': 13e-6, 'none': 19e-6})


@pytest.mark.parametrize('window', [(0.0, 100.0), (0.0, 120.0),
                                    (15.0, 95.0), (-5.0, 57.0)])
def test_parts_add_up_to_the_idle_time(window):
    out = layer_idle.split(EVENTS, *window)
    idle = out['window_s'] - out['busy_s']
    assert sum(out['layer_idle_s'].values()) == pytest.approx(idle)
    assert out['idle_s'] == pytest.approx(idle)
    assert idle / out['window_s'] == pytest.approx(
        1 - out['busy_s'] / out['window_s'])


def test_syncs_counted_inside_the_window_only():
    assert layer_idle.split(EVENTS, 0.0, 100.0)['syncs'] == 2
    assert layer_idle.split(EVENTS, 0.0, 120.0)['syncs'] == 3
    assert layer_idle.split(EVENTS, 60.0, 100.0)['syncs'] == 1


def test_window_of_a_named_span_or_the_whole_trace():
    ev = EVENTS + [{'ph': 'X', 'cat': 'user_annotation',
                    'name': 'gpubench.window', 'ts': 2, 'dur': 50}]
    assert layer_idle.window_of(ev, 'gpubench.window') == (2.0, 52.0)
    assert layer_idle.window_of(EVENTS, None) == (0.0, 102.0)


def test_b_least_s_hand_worked():
    """The 128 x 4 skinning net: 52,736 MACs, 108,538 flops an
    evaluation (2 x MACs, 4 x 512 hidden units, 768 for the blend, 250
    for the update), 167 bytes a row and 4 x (52,736 + 600) a launch."""
    ops = counts.b_least_s(10 ** 6, 300000, 2, ZJU_SKIN)
    assert ops == pytest.approx(1e6 * 108538 / 67e12)
    nbytes = counts.b_least_s(10, 300000, 2, ZJU_SKIN)
    assert nbytes == pytest.approx((300000 * 167 + 2 * 4 * 53336) / 3.35e12)


def test_cell_config_from_the_command_line():
    cfg = counts.cell_config(['run.py', '--workload', 'zju313.novel_view'])
    assert counts.skin_dims(cfg) == ZJU_SKIN
    assert counts.cell_config(['run.py', '--workload=zju313.novel_view']) \
        == cfg
    assert counts.cell_config(['run.py', '--seed', '1']) is None
    assert counts.cell_config(['run.py', '--workload', 'nope']) is None


FACTS = {'kind': 'render', 'rays': 200000,
         'trace': TraceSummary(6.0, 1.5, 60000, {'B': 0.4}, [], [])}
COUNTS = {'eval.sync.h2d': 40, 'eval.sync.d2h': 48,
          'tracer.sync.resolve': 36, 'tracer.sync.inv_affine': 12,
          'corr.p1': 3_000_000, 'corr.p2': 500_000,
          'corr.p1.points': 1_000_000, 'corr.rows': 1_600_000,
          'corr.launches': 24}


@pytest.fixture()
def given(monkeypatch):
    monkeypatch.setattr(counts, 'window_counts', lambda: dict(COUNTS))
    monkeypatch.setattr(sys, 'argv', ['run.py', '--workload',
                                      'zju313.novel_view', '--trace', '1'])


def test_readers_on_counts(given):
    assert reader('host_syncs_per_kray.render')(FACTS) == pytest.approx(
        136 / 200.0)
    assert reader('corr_evals_per_point.render')(FACTS) == pytest.approx(
        3.5)
    least = counts.b_least_s(3_500_000, 1_600_000, 24, ZJU_SKIN)
    assert reader('B_roofline.render')(FACTS) == pytest.approx(
        100 * least / 0.4)


def test_readers_without_counts(monkeypatch):
    """A program that keeps no counters (an older tree: its trace module
    is missing) gives nothing to read, and so does a run untraced."""
    monkeypatch.setitem(sys.modules, 'arah_tpu_torch.utils.trace', None)
    assert counts.window_counts() is None
    for name in ('host_syncs_per_kray.render', 'corr_evals_per_point.render',
                 'B_roofline.render'):
        assert reader(name)(FACTS) is None
        assert reader(name)({'kind': 'render'}) is None


def test_window_counts_read_without_reset():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from arah_tpu_torch.utils import trace
    trace.take_counts()
    assert counts.window_counts() is None
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.sync('tracer.sync.resolve'):
            torch.zeros(3)
    assert counts.window_counts() == {'tracer.sync.resolve': 1}
    assert counts.window_counts() == {'tracer.sync.resolve': 1}
    assert trace.take_counts() == {'tracer.sync.resolve': 1}
