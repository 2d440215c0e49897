"""Dataset preparation: raw ZJU-MoCap, Human3.6M and AIST++ downloads into
the layout the datasets (`data/human_video.py`, `data/odp.py`) read, and
the SMPL pickles into `body_models/misc/*.npz`. Port of the JAX package's
`preprocess/`: each script is a `main(argv)` run as

    python -m arah_tpu_torch.preprocess.<name> ...

with the JAX script's flags, and those that pose SMPL take `--device`
(default `cuda`, which must exist; `cpu` runs on the host).
"""
