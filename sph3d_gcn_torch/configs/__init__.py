"""Per-dataset architecture configs (counterparts of
``sph3d_gcn_tpu/configs``): ModelNet40, ShapeNet part segmentation,
S3DIS, ScanNet and RueMonge2014.

``fast=True`` selects the fast mode: bfloat16 activations, per-cloud
spatial sorting and the row windows; ``dense=True`` adds the dense
windowed engine. The default is the float32 reference-parity mode. An
undersized window is never silent: the forward's ``dense_ok`` certificate
turns False.
"""

import dataclasses

from sph3d_gcn_torch.configs.base import SPH3DConfig

# ModelNet40 row windows (encoder levels, decoder levels), calibrated on
# two families of synthetic clouds: 'plain' smooth ellipsoid surfaces and
# 'hard' bump-modulated ellipsoids (the JAX package's
# scripts/measure_windows.py)
_MODELNET_WINDOWS = {
    "plain": ((1536, 896, 640), (640, 384, 256)),
    "hard": ((2304, 1024, 640), (640, 512, 256)),
}


def _fast_mode(
    cfg: SPH3DConfig,
    windows: tuple[int, ...],
    dense: bool,
    dec_windows: tuple[int, ...],
    dec_margin: int,
    growth_steps: int,
) -> SPH3DConfig:
    # the dense engine's activations fit without recomputing the conv
    # blocks (JAX drops it there too)
    kw = {"remat_blocks": False} if dense else {}
    return dataclasses.replace(
        cfg,
        compute_dtype="bfloat16",
        spatial_sort=True,
        windows=windows[: len(cfg.num_sample)],
        dense_graph=dense,
        dec_windows=dec_windows[: len(cfg.num_sample)],
        dec_margin=dec_margin,
        growth_steps=growth_steps,
        **kw,
    )


def modelnet_config(
    num_input: int = 10000, fast: bool = False, dense: bool = False,
    family: str = "plain",
) -> SPH3DConfig:
    """ref modelnet40_cls/modelnet_config.py:1-37; ``family`` picks the
    fast mode's window calibration ('plain' or 'hard')."""
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
        windows, dec_windows = _MODELNET_WINDOWS[family]
        cfg = _fast_mode(cfg, windows, dense, dec_windows, dec_margin=128,
                         growth_steps=2)
    return cfg


def shapenet_config(
    num_input: int = 2048, fast: bool = False, dense: bool = False
) -> SPH3DConfig:
    """ref shapenet_seg/shapenet_config.py:1-24 (``num_cls`` is the
    one-hot model's 50 parts; a per-category model passes its own count)."""
    cfg = SPH3DConfig(
        num_input=num_input,
        num_cls=50,
        mlp=64,
        num_sample=(1024, 768, 384, 128),
        radius=(0.08, 0.16, 0.32, 0.64),
        nn_uplimit=(64, 64, 64, 64),
        channels=((128, 128), (256, 256), (256, 256), (512, 512)),
        multiplier=((2, 2), (2, 2), (2, 2), (2, 2)),
        weight_decay=None,
        kernel=(8, 2, 2),
        normalize=False,
        pool_method="max",
        unpool_method="mean",
        sample="FPS",
        with_bn=True,
        with_bias=False,
    )
    if fast:
        # calibrated by the JAX package's scripts/measure_windows.py on
        # the unit-sphere surface family at 2048 points (8% margin)
        cfg = _fast_mode(
            cfg, (512, 512, 640, 384), dense,
            dec_windows=(384, 384, 384, 128), dec_margin=256,
            growth_steps=2,
        )
    return cfg


def _scene_seg_config(
    num_cls: int, num_input: int = 8192, fast: bool = False,
    dense: bool = False,
) -> SPH3DConfig:
    # the reference pyramid at 8192 points, scaled proportionally for
    # smaller (test) inputs
    base = (2048, 768, 384, 128)
    if num_input != 8192:
        base = tuple(max(2, s * num_input // 8192) for s in base)
    cfg = SPH3DConfig(
        num_input=num_input,
        num_cls=num_cls,
        mlp=64,
        num_sample=base,
        radius=(0.1, 0.2, 0.4, 0.8),
        nn_uplimit=(64, 64, 64, 64),
        channels=((128, 128), (256, 256), (256, 256), (512, 512)),
        multiplier=((2, 2), (2, 2), (2, 2), (2, 2)),
        weight_decay=None,
        kernel=(8, 2, 2),
        normalize=True,
        pool_method="max",
        unpool_method="mean",
        sample="FPS",
        with_bn=True,
        with_bias=False,
        # the reference size recomputes its conv blocks in the backward,
        # as the JAX config does (sized there for a 16 GiB chip)
        remat_blocks=num_input >= 4096,
    )
    if fast:
        # calibrated by the JAX package's scripts/measure_windows.py over
        # uniform 1.5 m blocks and plane-heavy blocks (8% margin), scaled
        # for other input sizes
        def _scale(w, cap=8192):
            return tuple(
                min(-(-x * num_input // 8192 // 128) * 128, cap) for x in w
            )

        cfg = _fast_mode(
            cfg, _scale((1664, 896, 640, 384)), dense,
            dec_windows=_scale((640, 512, 384, 128)),
            dec_margin=128, growth_steps=3,
        )
    return cfg


def scannet_config(
    num_input: int = 8192, fast: bool = False, dense: bool = False
) -> SPH3DConfig:
    """ref scannet_seg/scannet_config.py:1-26."""
    return _scene_seg_config(
        num_cls=21, num_input=num_input, fast=fast, dense=dense
    )


def s3dis_config(
    num_input: int = 8192, fast: bool = False, dense: bool = False
) -> SPH3DConfig:
    """ref s3dis_seg/s3dis_config.py:1-26."""
    return _scene_seg_config(
        num_cls=13, num_input=num_input, fast=fast, dense=dense
    )


def ruemonge2014_config(
    num_input: int = 8192, fast: bool = False, dense: bool = False
) -> SPH3DConfig:
    """ref ruemonge2014_seg/ruemonge2014_config.py:1-26."""
    return _scene_seg_config(
        num_cls=7, num_input=num_input, fast=fast, dense=dense
    )


__all__ = ["SPH3DConfig", "modelnet_config", "ruemonge2014_config",
           "s3dis_config", "scannet_config", "shapenet_config"]
