"""The port's config reader against PyYAML and the JAX package's loader
on the CPU: `config/yaml_lite.py` gives `yaml.safe_load`'s objects, types
included, on every file under `configs/` and refuses the forms it does
not take; `config/loader.py` gives the JAX loader's merged dict and, field
for field, its ModelConfig, LossWeights and OptimConfig for every config.
Exact equality throughout."""
import glob
import math
import os

import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'configs', '**', '*.yaml'), recursive=True))


def same(a, b):
    """Equal values of the same types, all the way down (so that 1, 1.0
    and True differ)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_every_config_is_covered():
    assert len(CONFIGS) >= 27, CONFIGS


@pytest.mark.parametrize('path', CONFIGS)
def test_yaml_lite_equals_safe_load(path):
    from arah_tpu_torch.config.yaml_lite import load_file
    full = os.path.join(ROOT, path)
    with open(full) as f:
        ref = yaml.safe_load(f)
    assert same(load_file(full), ref)


@pytest.mark.parametrize('text', [
    "a: 1\nb: [1, 2.5, 'x', \"y\\n\", null, true, ~]\n",
    'a:\n- 1\n- [2, 3]\nb: {c: {d: 1e}, e: []}\n',
    'x: &a [1, 2]\ny: *a\nz: &b\n  - q\nw: *b\n',
    "k: .5\nl: -.inf\nm: 1.0e+1\nn: '1'\no: 'it''s'\np:\n",
    'a: {x: 1,\n  y: [2,\n    3]}\nb: 3 # comment\n# whole line\n',
    '- a\n- b\n',
    'a:\n  - b\n  -\n    c: 1\n',
    'outer:\n  inner: -7\n  s: plain text with spaces\n',
])
def test_yaml_lite_forms(text):
    from arah_tpu_torch.config.yaml_lite import loads
    assert same(loads(text), yaml.safe_load(text))


@pytest.mark.parametrize('text', [
    'a: yes\n', 'a: 1e5\n', 'a: !!str x\n', 'a: |\n  x\n', 'a: 0x1f\n',
    'a: 017\n', 'a: 1_000\n', '---\na: 1\n', 'a:\n\t- b\n',
    'a:\n  - b: 1\n', 'a: *nothing\n', 'a: [1, 2\n',
])
def test_yaml_lite_refuses(text):
    from arah_tpu_torch.config.yaml_lite import YamlError, loads
    with pytest.raises(YamlError, match='<string>:'):
        loads(text)


@pytest.mark.parametrize('path', CONFIGS)
def test_loader_vs_jax(path, monkeypatch):
    """load_config with the default config, and the three typed configs,
    equal the JAX loader's field for field (nested configs included)."""
    from arah_tpu.config import loader as jl
    from arah_tpu_torch.config import loader as pl
    monkeypatch.chdir(ROOT)
    jcfg = jl.load_config(path, 'configs/default.yaml')
    pcfg = pl.load_config(path, pl.default_config_path())
    assert same(pcfg, jcfg)
    for fn in ('model_config_from_cfg', 'loss_weights_from_cfg',
               'optim_config_from_cfg'):
        j, p = getattr(jl, fn)(jcfg), getattr(pl, fn)(pcfg)
        assert list(p._fields) == list(j._fields), fn
        for f in j._fields:
            jv, pv = getattr(j, f), getattr(p, f)
            if hasattr(jv, '_asdict'):
                assert same(pv._asdict(), jv._asdict()), (fn, f)
            else:
                assert same(pv, jv), (fn, f, pv, jv)
