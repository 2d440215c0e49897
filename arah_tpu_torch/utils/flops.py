"""Analytic matmul FLOPs of the flagship train step. Port of
`arah_tpu/utils/flops.py` (pure Python), for the model-FLOPs numerator of
a utilisation figure: the hot loops have data-dependent trip counts
(Broyden and sphere-trace early exits), so the solver iterations are
parameters, charged `iters x` the per-iteration FLOPs (the configured
caps for a provisioned bound, measured counts for executed work).

Matmul FLOPs (2 m n k) only: elementwise work (sines, softplus,
compositing, losses, Adam) is left out; a backward pass is charged twice
its forward (the dW and dx products)."""
from __future__ import annotations


def mlp_fwd_flops(shapes) -> int:
    """Forward matmul FLOPs a point of a chain of (out, in) weights."""
    return sum(2 * int(o) * int(i) for o, i in shapes)


def siren_shade_fwd_flops(shapes) -> int:
    """The shading forward (kernel C): the primal chain over all L
    layers and the reverse normal chain over the L - 1 sine layers
    (seeded from the SDF row, so the last layer costs nothing)."""
    return mlp_fwd_flops(shapes) + mlp_fwd_flops(shapes[:-1])


def siren_shade_bwd_flops(shapes) -> int:
    """The shading backward (kernel H): the primal (L - 1), normal chain
    (L - 1), adjoint of the reverse tangent chain (L - 1) and its dW
    (L - 1), the primal backward's dW (L) and h-cotangent chain (L), and
    the output layer's terms."""
    sine = mlp_fwd_flops(shapes[:-1])
    full = mlp_fwd_flops(shapes)
    return 4 * sine + 2 * full + 2 * mlp_fwd_flops(shapes[-1:])


def train_step_flops(*, n_rays: int, n_samples: int, n_verts: int,
                     siren_shapes, skin_shapes, color_shapes,
                     hypernet_params: int,
                     corr_iters: float, march_iters: float,
                     iso_iters: float,
                     n_eik: int = 1024, n_reg: int = 1024 * 3,
                     train_skinning_net: bool = True,
                     shade_frac: float = 1.0,
                     idiff_standalone: bool = False) -> dict:
    """Matmul-FLOPs breakdown of one train step: {'total': float,
    'blocks': {name: flops}}. siren_shapes / skin_shapes / color_shapes:
    [(out, in), ...] of the generated SIREN's, skinning MLP's and colour
    MLP's weights; hypernet_params: the hypernetwork's parameter count;
    shade_frac: the share of the dense (ray, sample) slots shaded
    (`shade_pack`; the tracer runs on every dense slot);
    idiff_standalone: the implicit-diff Jacobian from B's own launch
    (primal and 3 tangent sweeps, no backward)."""
    N_dense = n_rays * n_samples
    N = int(round(N_dense * shade_frac))
    skin = mlp_fwd_flops(skin_shapes)
    siren = mlp_fwd_flops(siren_shapes)
    color = mlp_fwd_flops(color_shapes)
    knn = 2 * 4 * n_verts          # [p|1] x [-2v ; |v|^2] a point
    lbs = 2 * 24 * 16              # weights x bone transforms a point

    blocks = {
        'shade_fwd': N * siren_shade_fwd_flops(siren_shapes),
        'shade_bwd': N * siren_shade_bwd_flops(siren_shapes),
        'color': 3 * N * color,
        # correspondences: KNN + skinning init, then skinning + LBS an
        # iteration, on every dense sample
        'corr_init': N_dense * (knn + skin + lbs),
        'corr_loop': int(N_dense * corr_iters * (skin + lbs)),
        # the march runs on ray heads: KNN, skinning, LBS and SIREN
        'march_loop': int(n_rays * march_iters * (knn + skin + lbs + siren)),
        # iso refinement: a 4-pass Jacobian init, then skinning + SIREN
        'iso_init': n_rays * 4 * (skin + lbs + siren),
        'iso_loop': int(n_rays * iso_iters * (skin + lbs + siren)),
        'eikonal': n_eik * (siren_shade_fwd_flops(siren_shapes)
                            + siren_shade_bwd_flops(siren_shapes)),
        'reg_points': 3 * n_reg * (siren + skin),
        'hypernet': 3 * 2 * hypernet_params,
    }
    if train_skinning_net and idiff_standalone:
        blocks['implicit_diff'] = N * 7 * (skin + lbs)
    elif train_skinning_net:
        blocks['implicit_diff'] = 3 * N * 5 * (skin + lbs)
    blocks = {k: float(v) for k, v in blocks.items()}
    return {'total': sum(blocks.values()), 'blocks': blocks}


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return int(tree.numel())


def model_shapes(params, gen, color_key: str = 'color'):
    """(siren_shapes, skin_shapes, color_shapes, hypernet_params) of the
    port's parameter tree: gen is a `GeneratedMLP` (`generate_sdf`), the
    skinning and colour 'layers' weight-normed ('v') or dense ('w')."""
    def w_of(layer):
        return layer['v'] if 'v' in layer else layer['w']
    siren_shapes = [tuple(w.shape) for w in gen.weights]
    skin_shapes = [tuple(w_of(l).shape)
                   for l in params['skinning']['layers']]
    color_shapes = [tuple(w_of(l).shape)
                    for l in params[color_key]['layers']]
    hyper = _numel(params['hypernet']) if 'hypernet' in params else 0
    return siren_shapes, skin_shapes, color_shapes, hyper
