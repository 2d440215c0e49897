"""Move a JAX parameter tree into the port.

The port's parameter tree mirrors the JAX one key for key (dicts stay
dicts, lists stay lists), so conversion is a tree map from numpy arrays
to tensors. Pass the JAX tree as numpy, e.g.
`jax.tree.map(np.asarray, params)`; the port itself never imports JAX.
The same map moves any of the JAX package's parameter trees whose port
keeps its layout: the model's (`model.init_model_params`) and the
geometric-init SDF MLP's (`nn/sdf_mlp.py:init_sdf_mlp`).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device='cuda'):
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    float32 (or the array's own integer dtype) tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    a = np.array(tree)
    if a.dtype.kind == 'f':
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)
