"""arah_tpu_torch — ARAH in PyTorch (the CLIs, training, validation and
the renderer), with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

A port of the `arah_tpu` JAX package, which stays the reference. The
layout mirrors it module for module (`core/`, `nn/`, `solver/`,
`render/`, `ops/`, `model.py`), and the parameter tree mirrors the JAX
tree key for key (`convert.params_from_jax` moves one across).

Entry points run on `cuda` unless the caller passes `device='cpu'`.
Each kernel wrapper in `ops/` launches its CUDA kernel for a CUDA tensor
and computes its plain PyTorch version only for a CPU tensor; the
kernels build from `csrc/` with `nvcc` at first use (`ops/_build.py`).
This package imports torch, numpy and scipy, never JAX and nothing of
`arah_tpu`, and neither PyYAML nor OpenCV: it reads its YAML configs and
its images with its own code (`config/yaml_lite.py`, `utils/image.py`).
The CLIs are `python -m arah_tpu_torch.cli.train` and `.cli.validate`.
"""
