"""NeRF positional encoding, output layout
[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...] with all input
dims grouped per frequency. A frozen copy of the port's `core/embedder.py`."""
from __future__ import annotations

import torch


def embedding_dim(multires: int, input_dims: int = 3,
                  include_input: bool = True) -> int:
    return input_dims * (include_input + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int,
                        include_input: bool = True) -> torch.Tensor:
    """(..., D) -> (..., D * (include_input + 2*multires))."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=torch.float32,
                                device=x.device)
    D = x.shape[-1]
    xf = x[..., None, :] * freqs[:, None]                 # (..., M, D)
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., M, 2, D)
    sc = sc.reshape(x.shape[:-1] + (2 * multires * D,))
    if include_input:
        return torch.cat([x, sc], dim=-1)
    return sc
