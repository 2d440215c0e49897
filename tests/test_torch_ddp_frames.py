"""The port's data-parallel train step in per-block-frame mode
(`make_train_step(mesh=..., per_block_frame=True)`: each rank's ray
block on its own frame and latent row) over two gloo ranks on the CPU,
against JAX's sharded step on two virtual devices, by the rules of
`test_torch_ddp.py` (a file of its own, so that the two JAX compiles of
each mode run beside each other)."""
from test_torch_ddp import _check_ddp


def test_two_ranks_per_block_frame_vs_jax_mesh(tmp_path):
    _check_ddp(tmp_path, pbf=True)
