"""Per-dataset architecture configs (counterparts of
``sph3d_gcn_tpu/configs``). Only ModelNet40 is ported so far.

``fast=True`` selects the fast mode: bfloat16 activations, per-cloud
spatial sorting and the row windows; ``dense=True`` adds the dense
windowed engine. The default is the float32 reference-parity mode.
"""

import dataclasses

from sph3d_gcn_torch.configs.base import SPH3DConfig

# ModelNet40 row windows per encoder level, calibrated on two families of
# synthetic clouds: 'plain' smooth ellipsoid surfaces and 'hard'
# bump-modulated ellipsoids (the JAX package's scripts/measure_windows.py)
_MODELNET_WINDOWS = {"plain": (1536, 896, 640), "hard": (2304, 1024, 640)}


def modelnet_config(
    num_input: int = 10000, fast: bool = False, dense: bool = False,
    family: str = "plain",
) -> SPH3DConfig:
    """ref modelnet40_cls/modelnet_config.py:1-37; ``family`` picks the
    fast mode's window calibration ('plain' or 'hard'). An undersized
    window is never silent: the forward's ``dense_ok`` certificate turns
    False."""
    num_sample = tuple(
        num_input // 4 ** (i + 1)
        for i in range(10)
        if num_input // 4 ** (i + 1) > 100
    )
    num_levels = len(num_sample)
    cfg = SPH3DConfig(
        num_input=num_input,
        num_cls=40,
        mlp=32,
        num_sample=num_sample,
        radius=(0.1, 0.2, 0.4)[:num_levels],
        nn_uplimit=(64,) * num_levels,
        channels=((64, 64), (64, 128), (128, 128))[:num_levels],
        multiplier=((2, 1), (1, 2), (1, 1))[:num_levels],
        weight_decay=1e-5,
        kernel=(8, 2, 2),
        normalize=True,
        pool_method="max",
        sample="FPS",
        use_raw=True,
        with_bn=True,
        with_bias=False,
        global_channels=512,
        global_multiplier=2,
    )
    if fast:
        if family not in _MODELNET_WINDOWS:
            raise ValueError(f"unknown window family {family!r}")
        cfg = dataclasses.replace(
            cfg,
            compute_dtype="bfloat16",
            spatial_sort=True,
            windows=_MODELNET_WINDOWS[family][:num_levels],
            dense_graph=dense,
        )
    return cfg


__all__ = ["SPH3DConfig", "modelnet_config"]
