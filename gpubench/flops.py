"""The yardstick's arithmetic: the published peaks of one H100, the
model FLOPs of an image (frozen from the port's `utils/flops.py`, with
the solver iterations fixed), and kernel C's least time from its
operations and bytes at the traced shapes.

Matrix-product FLOPs (2 m n k) only. Under `bf16_shading` the SIREN's
and the colour MLP's hidden products run on the tensor cores in bf16 and
their first and last layers on the CUDA cores in f32 (the port's kernels
C and D), so each part is charged at its own peak.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK = {'bf16': 989e12, 'f32': 67e12, 'hbm': 3.35e12}

# the solver iterations charged to every image: one evaluation a
# solver, the fewest any run takes, so that the share is a floor that
# no solver's count can raise (the counts are the program's, unread)
MODEL_ITERS = {'corr': 1, 'march': 1, 'iso': 1}


def mlp_fwd_flops(shapes) -> int:
    """Forward matmul FLOPs a point of a chain of (out, in) weights."""
    return sum(2 * int(o) * int(i) for o, i in shapes)


def siren_shade_fwd_flops(shapes) -> int:
    """The shading forward (kernel C): the primal chain over all L layers
    and the reverse normal chain over the L - 1 sine layers."""
    return mlp_fwd_flops(shapes) + mlp_fwd_flops(shapes[:-1])


def _at_peaks(hidden: float, other: float, bf16: bool) -> float:
    """Seconds of `hidden` FLOPs of hidden-layer products (at the bf16
    peak under `bf16`) and `other` FLOPs at the f32 peak."""
    if not bf16:
        return (hidden + other) / PEAK['f32']
    return hidden / PEAK['bf16'] + other / PEAK['f32']


def shade_fwd_least_s(shapes, n_points: int, bf16: bool) -> float:
    """Least seconds of the shading forward over n_points: its hidden
    layers (all but the first and last) appear twice in the formula."""
    hidden = 2 * mlp_fwd_flops(shapes[1:-1]) * n_points
    return _at_peaks(hidden, siren_shade_fwd_flops(shapes) * n_points
                     - hidden, bf16)


def color_layers_least_s(color_shapes, n_points: int, passes: int,
                         bf16: bool) -> float:
    """Least seconds of `passes` products a layer of the colour MLP over
    n_points: every layer but the last (3 outputs) at the bf16 peak when
    `bf16`."""
    return _at_peaks(mlp_fwd_flops(color_shapes[:-1]) * n_points * passes,
                     mlp_fwd_flops(color_shapes[-1:]) * n_points * passes,
                     bf16)


def c_least_s(siren_shapes, n_points: int, bf16: bool) -> float:
    """Kernel C's least seconds: the shading forward, or its bytes (a
    point's coordinates in; SDF, normal and features out)."""
    ops = shade_fwd_least_s(siren_shapes, n_points, bf16)
    width = siren_shapes[-1][1]
    out_bytes = 4 * (1 + 3) + (2 if bf16 else 4) * width
    return max(ops, n_points * (12 + out_bytes) / PEAK['hbm'])


def image_least_s(*, n_rays: int, n_samples: int, n_verts: int,
                  siren_shapes, skin_shapes, color_shapes,
                  hypernet_params: int, bf16: bool,
                  iters: dict = MODEL_ITERS) -> dict:
    """The least seconds of an image's model FLOPs (the evaluator's
    forward, no gradients) over its `n_rays` rays, each block at the peak
    of its precision: {'total': s, 'blocks': {name: s}}."""
    N = n_rays * n_samples
    skin = mlp_fwd_flops(skin_shapes)
    siren = mlp_fwd_flops(siren_shapes)
    knn = 2 * 4 * n_verts
    lbs = 2 * 24 * 16
    f32 = PEAK['f32']
    blocks = {
        'shade_fwd': shade_fwd_least_s(siren_shapes, N, bf16),
        'color': color_layers_least_s(color_shapes, N, 1, bf16),
        'corr_init': N * (knn + skin + lbs) / f32,
        'corr_loop': N * iters['corr'] * (skin + lbs) / f32,
        'march_loop': n_rays * iters['march'] * (knn + skin + lbs + siren)
        / f32,
        'iso_init': n_rays * 4 * (skin + lbs + siren) / f32,
        'iso_loop': n_rays * iters['iso'] * (skin + lbs + siren) / f32,
        'hypernet': 2 * hypernet_params / f32,
    }
    return {'total': sum(blocks.values()), 'blocks': blocks}


def numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(numel(v) for v in tree)
    return int(tree.numel())


def model_shapes(params, gen):
    """(siren_shapes, skin_shapes, color_shapes, hypernet_params) of a
    parameter tree: gen is the generated SIREN (its weights), the
    skinning and colour layers weight-normed ('v') or dense ('w')."""
    def w_of(layer):
        return layer['v'] if 'v' in layer else layer['w']
    return ([tuple(w.shape) for w in gen.weights],
            [tuple(w_of(l).shape) for l in params['skinning']['layers']],
            [tuple(w_of(l).shape) for l in params['color']['layers']],
            numel(params['hypernet']))
