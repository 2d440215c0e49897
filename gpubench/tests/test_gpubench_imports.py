"""Nothing under gpubench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: `arah_tpu_torch` is not `arah_tpu`."""
import ast
import os

import pytest

from gpubench.harness import FORBIDDEN, forbidden_modules

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sources(sub=''):
    root = os.path.join(HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def top_level_imports(path):
    """The top-level names of every module the file imports (absolute
    imports; a relative one names the package itself)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add('gpubench' if node.level else
                      node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', None)) in (
                    'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split('.')[0])
    return names


def test_the_forbidden_names():
    assert set(FORBIDDEN) == {'jax', 'jaxlib', 'flax', 'arah_tpu'}


@pytest.mark.parametrize('path', sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize('path', sorted(sources('reference')),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_takes_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert 'arah_tpu_torch' not in names
    assert names <= {'gpubench', 'torch', 'numpy', 'math', 'typing',
                     '__future__', 'contextlib', 'time'}


def test_whole_names_are_compared():
    assert forbidden_modules(['arah_tpu_torch', 'arah_tpu_torch.ops',
                              'jaxtyping', 'torch']) == []
    assert forbidden_modules(['arah_tpu.model', 'jax.numpy', 'flax',
                              'arah_tpu_torch']) == ['arah_tpu', 'flax',
                                                     'jax']
