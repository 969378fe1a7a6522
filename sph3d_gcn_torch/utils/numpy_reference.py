"""Vectorized NumPy forwards of the ModelNet classifier and the scene
segmentation model: the independent side of the port's full-model logit
parity (the port's copy of the JAX package's
``scripts/numpy_reference.py``).

NumPy only: no torch and no JAX. The core ops are vectorized versions of
the reference's CUDA semantics (the JAX package's loop oracle
``ops/_ref.py``; ``tests/test_torch_parity_tools.py`` holds them
against it), and the model forwards are built from them alone (ref
models/SPH3D_modelnet.py:33-108, models/SPH3D_s3dis.py:35-113,
utils/sph3gcn_util.py:88-332). The variables are Flax-shaped trees
(``{"params": ..., "batch_stats": ...}``); a port model's reach it
through ``utils.convert.flax_tree_from_torch``. ``cli.parity_check
--oracle`` compares a model's logits with these at full width.

Everything is float32 end-to-end, mirroring the reference's TF1/CUDA
precision. Eval-mode only (BN running stats, no dropout).

One addition to the JAX copy: a config with ``spatial_sort`` (the fast
modes) is accepted for a cloud its caller has already sorted as the
model sorts it (``ops.locality.spatial_sort``, so that the model's own
sort is the identity); each level's sample indices are then taken in
ascending order, as the fast engines keep each coarser cloud sorted
(``models/modelnet.py``, ``models/segmentation.py``). Without
``spatial_sort`` the forwards are the JAX copy's, line for line.
"""

from __future__ import annotations

import numpy as np

M_EPS = 1.01e-3  # ref tf_buildkernel_gpu.cu:6
_QUERY_CHUNK = 2048


# ------------------------- vectorized core ops -------------------------

def sphere_neighbor(db, q, radius, k, grow=True):
    """Vectorized `_ref.sphere_neighbor` (ref tf_nnquery_gpu.cu:15-66):
    first-k in point order within strict <radius (1e-6 boundary margin),
    count clamped to k, sqrt-space stored distances, +0.05 radius growth
    for zero-neighbor rows."""
    db = np.asarray(db, np.float32)[..., :3]
    q = np.asarray(q, np.float32)[..., :3]
    b, n, _ = db.shape
    m = q.shape[1]
    nn_index = np.zeros((b, m, k), np.int32)
    nn_count = np.zeros((b, m), np.int32)
    nn_dist = np.zeros((b, m, k), np.float32)
    for i in range(b):
        for s0 in range(0, m, _QUERY_CHUNK):
            rows = np.arange(s0, min(s0 + _QUERY_CHUNK, m))
            r = np.full((len(rows),), np.float32(radius), np.float32)
            delta = db[i][None, :, :] - q[i, rows][:, None, :]
            d3 = np.sqrt(np.sum(delta * delta, axis=-1, dtype=np.float32))
            while True:
                in_r = (d3 < r[:, None]) & (
                    np.abs(d3 - r[:, None]) > np.float32(1e-6)
                )
                total = in_r.sum(axis=1)
                if not grow or (total > 0).all():
                    break
                r = np.where(total > 0, r, r + np.float32(0.05))
            order = np.cumsum(in_r, axis=1)
            sel = in_r & (order <= k)
            rs, cs = np.nonzero(sel)
            pos = order[rs, cs] - 1
            nn_index[i, rows[rs], pos] = cs
            nn_dist[i, rows[rs], pos] = np.sqrt(d3[rs, cs])  # sqrt-space
            nn_count[i, rows] = np.minimum(total, k)
    return nn_index, nn_count, nn_dist


def farthest_point_sample(npoint, db):
    """Vectorized `_ref.farthest_point_sample` (ref tf_sample_gpu.cu:7-78):
    seed 0, greedy max-min in squared distance, ties -> first index."""
    db = np.asarray(db, np.float32)[..., :3]
    b, n, _ = db.shape
    out = np.zeros((b, npoint), np.int32)
    for i in range(b):
        temp = np.full((n,), 1e38, np.float32)
        old = 0
        for j in range(1, npoint):
            delta = db[i] - db[i, old]
            d = np.sum(delta * delta, axis=-1, dtype=np.float32)
            temp = np.minimum(temp, d)
            old = int(np.argmax(temp))
            out[i, j] = old
    return out


def spherical_kernel(db, q, nn_index, nn_count, nn_dist, radius, kernel):
    """Vectorized `_ref.spherical_kernel` (ref tf_buildkernel_gpu.cu:20-78):
    bin 0 is the self-loop (dist <= M_EPS with 1e-6 margin)."""
    db = np.asarray(db, np.float32)[..., :3]
    q = np.asarray(q, np.float32)[..., :3]
    n_bins, p_bins, q_bins = kernel
    b, m, k = nn_index.shape
    delta = np.take_along_axis(
        db[:, :, None, :], nn_index[..., None], axis=1
    ) - q[:, :, None, :]
    dist = nn_dist
    dist2d = np.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2)
    theta = np.arctan2(delta[..., 1], delta[..., 0]).astype(np.float32)
    theta = np.where(theta < np.pi, theta, -np.pi)
    theta = np.maximum(theta, -np.pi) + np.float32(np.pi)
    phi = np.clip(
        np.arctan2(delta[..., 2], dist2d), -np.pi / 2, np.pi / 2
    ).astype(np.float32) + np.float32(np.pi / 2)
    n_id = np.minimum(n_bins - 1, (theta * n_bins / 2 / np.pi).astype(np.int32))
    p_id = np.minimum(p_bins - 1, (phi * p_bins / np.pi).astype(np.int32))
    g_id = np.minimum(
        q_bins - 1, (dist * q_bins / np.float32(radius + 1e-6)).astype(np.int32)
    )
    filt = g_id * p_bins * n_bins + p_id * n_bins + n_id + 1
    is_self = (dist <= M_EPS) | (np.abs(dist - M_EPS) <= 1e-6)
    filt = np.where(is_self, 0, filt)
    valid = np.arange(k)[None, None, :] < nn_count[..., None]
    return np.where(valid, filt, 0).astype(np.int32)


def depthwise_conv3d(inputs, filt, nn_index, nn_count, bin_index):
    """Vectorized `_ref.depthwise_conv3d` (ref tf_conv3d_gpu.cu:7-29):
    gather + per-bin weight + mean over the nn_count neighbors."""
    inputs = np.asarray(inputs, np.float32)
    filt = np.asarray(filt, np.float32)
    b, n, c = inputs.shape
    f_bins, _, r = filt.shape
    m, k = nn_index.shape[1], nn_index.shape[2]
    out = np.zeros((b, m, c * r), np.float32)
    for i in range(b):
        for s0 in range(0, m, _QUERY_CHUNK):
            sl = slice(s0, min(s0 + _QUERY_CHUNK, m))
            idx = nn_index[i, sl]                      # (mc, K)
            feats = inputs[i][idx]                     # (mc, K, C)
            fg = filt[bin_index[i, sl]]                # (mc, K, C, r)
            v = (np.arange(k)[None, :] < nn_count[i, sl][:, None])
            contrib = feats[..., None] * fg            # (mc, K, C, r)
            contrib *= v[..., None, None]
            s = contrib.sum(axis=1, dtype=np.float32)  # (mc, C, r)
            cnt = np.maximum(nn_count[i, sl], 1).astype(np.float32)
            out[i, sl] = (s / cnt[:, None, None]).reshape(len(idx), c * r)
    return out


def max_pool3d(inputs, nn_index, nn_count):
    """Vectorized `_ref.max_pool3d` (ref tf_pool3d_gpu.cu:5-34): per-channel
    max over valid neighbors, argmax = first maximal in point order."""
    inputs = np.asarray(inputs, np.float32)
    b, n, c = inputs.shape
    m, k = nn_index.shape[1], nn_index.shape[2]
    out = np.zeros((b, m, c), np.float32)
    max_index = np.zeros((b, m, c), np.int32)
    for i in range(b):
        feats = inputs[i][nn_index[i]]                 # (M, K, C)
        v = np.arange(k)[None, :] < nn_count[i][:, None]
        vals = np.where(v[..., None], feats, -np.inf)
        out[i] = np.where(nn_count[i][:, None] > 0, vals.max(axis=1), 0.0)
        arg_k = vals.argmax(axis=1)                    # first max
        max_index[i] = np.take_along_axis(
            nn_index[i], arg_k, axis=1
        ) * (nn_count[i][:, None] > 0)
    return out, max_index


def mean_interpolate(inputs, nn_index, nn_count):
    """Vectorized `_ref.mean_interpolate` (ref tf_unpool3d_gpu.cu:5-22)."""
    inputs = np.asarray(inputs, np.float32)
    b = inputs.shape[0]
    n, k = nn_index.shape[1], nn_index.shape[2]
    out = np.zeros((b, n, inputs.shape[2]), np.float32)
    for i in range(b):
        feats = inputs[i][nn_index[i]]
        v = np.arange(k)[None, :] < nn_count[i][:, None]
        s = (feats * v[..., None]).sum(axis=1, dtype=np.float32)
        out[i] = s / np.maximum(nn_count[i], 1).astype(np.float32)[:, None]
    return out


def weighted_interpolate(inputs, weight, nn_index, nn_count):
    """Vectorized `_ref.weighted_interpolate` (ref tf_unpool3d_gpu.cu:45-63)."""
    inputs = np.asarray(inputs, np.float32)
    weight = np.asarray(weight, np.float32)
    b = inputs.shape[0]
    n, k = nn_index.shape[1], nn_index.shape[2]
    out = np.zeros((b, n, inputs.shape[2]), np.float32)
    for i in range(b):
        feats = inputs[i][nn_index[i]]
        v = np.arange(k)[None, :] < nn_count[i][:, None]
        w = weight[i] * v
        out[i] = (feats * w[..., None]).sum(axis=1, dtype=np.float32)
    return out


# --------------------------- layer helpers ---------------------------

def _elu(x):
    return np.where(x > 0, x, np.expm1(np.minimum(x, 0.0))).astype(np.float32)


def _bn_eval(x, params, stats, eps=1e-3):
    """TF-flavored eval-mode BN (running stats, momentum irrelevant here;
    ref utils/sph3gcn_util.py:328-332)."""
    bn_p = params["bn"]["BatchNorm_0"]
    bn_s = stats["bn"]["BatchNorm_0"]
    inv = 1.0 / np.sqrt(bn_s["var"].astype(np.float32) + np.float32(eps))
    return ((x - bn_s["mean"]) * inv * bn_p["scale"] + bn_p["bias"]).astype(
        np.float32
    )


def _act_bn(x, params, stats, with_bn):
    """ELU THEN batch-norm — the reference's unusual ordering
    (ref utils/sph3gcn_util.py:157-161)."""
    x = _elu(x)
    if with_bn:
        x = _bn_eval(x, params, stats)
    return x


def _pointwise(x, params, stats, with_bn, activation=True):
    out = (x @ params["weights"]).astype(np.float32)
    if "biases" in params:
        out = out + params["biases"]
    if activation:
        out = _act_bn(out, params, stats, with_bn)
    return out


def _separable_conv(x, params, stats, nbh, bins, with_bn):
    """Depthwise bin conv -> pointwise matmul -> ELU -> BN
    (ref utils/sph3gcn_util.py:88-163)."""
    nn_index, nn_count = nbh
    out = depthwise_conv3d(x, params["depthwise_weights"], nn_index,
                           nn_count, bins)
    out = (out @ params["weights"]).astype(np.float32)
    if "biases" in params:
        out = out + params["biases"]
    return _act_bn(out, params, stats, with_bn)


def _conv_block(x, params, stats, nbh, bins, channels, with_bn):
    for i in range(len(channels)):
        name = f"_{i + 1}"
        x = _separable_conv(x, params[name], stats[name], nbh, bins, with_bn)
    return x


def normalize_unit_sphere(points):
    """ref models/SPH3D_modelnet.py:11-17 (with the zero-scale guard the
    JAX model adds)."""
    points = points - points.mean(axis=1, keepdims=True, dtype=np.float32)
    scale = np.square(points).sum(axis=-1, keepdims=True).max(
        axis=1, keepdims=True
    )
    return (points / np.sqrt(np.maximum(scale, 1e-12))).astype(np.float32)


def normalize_xy_center_z_floor(points):
    """ref models/SPH3D_s3dis.py:11-19."""
    mn = points.min(axis=1, keepdims=True)
    mx = points.max(axis=1, keepdims=True)
    center = (mx + mn) / 2
    xy = points[:, :, 0:2] - center[:, :, 0:2]
    return np.concatenate((xy, points[:, :, 2:]), axis=2).astype(np.float32)


# --------------------------- model forwards ---------------------------

_GLOBAL_RADIUS = 100.0
_GLOBAL_KERNEL = (8, 2, 1)


def _sample(cfg, npoint, xyz):
    """FPS indices of a level, ascending under ``cfg.spatial_sort``."""
    samp = farthest_point_sample(npoint, xyz)
    return np.sort(samp, axis=1) if cfg.spatial_sort else samp


def forward_modelnet(variables, cfg, points):
    """NumPy eval-mode forward of SPH3DModelNet (f32; a ``spatial_sort``
    config on a cloud already sorted, see the module docstring). Mirrors
    models/modelnet.py step for step (ref models/SPH3D_modelnet.py:33-108).
    """
    params = variables["params"]
    stats = variables["batch_stats"]
    points = np.asarray(points, np.float32)
    assert cfg.compute_dtype == "float32"

    if cfg.normalize:
        points = normalize_unit_sphere(points)
    xyz = points
    query = xyz.mean(axis=1, keepdims=True, dtype=np.float32)

    net = _pointwise(points, params["mlp1"], stats["mlp1"], cfg.with_bn)

    global_feat = []
    for level in range(len(cfg.radius)):
        if cfg.use_raw:
            net = np.concatenate([net, xyz], axis=-1)
        nn_index, nn_count, nn_dist = sphere_neighbor(
            xyz, xyz, cfg.radius[level], cfg.nn_uplimit[level], grow=False
        )
        bins = spherical_kernel(
            xyz, xyz, nn_index, nn_count, nn_dist, cfg.radius[level],
            cfg.kernel,
        )
        name = f"conv{level + 1}"
        net = _conv_block(net, params[name], stats[name],
                          (nn_index, nn_count), bins, cfg.channels[level],
                          cfg.with_bn)
        if cfg.num_sample[level] > 1:
            samp = _sample(cfg, cfg.num_sample[level], xyz)
            xyz = np.take_along_axis(xyz, samp[..., None], axis=1)
            idx_s = np.take_along_axis(nn_index, samp[..., None], axis=1)
            cnt_s = np.take_along_axis(nn_count, samp, axis=1)
            net, _ = max_pool3d(net, idx_s, cnt_s)
        global_feat.append(net.max(axis=1, keepdims=True))

    gi, gc, gd = sphere_neighbor(xyz, query, _GLOBAL_RADIUS, xyz.shape[1])
    gbins = spherical_kernel(xyz, query, gi, gc, gd, _GLOBAL_RADIUS,
                             _GLOBAL_KERNEL)
    net = _separable_conv(net, params["global_conv"], stats["global_conv"],
                          (gi, gc), gbins, cfg.with_bn)
    global_feat.append(net)
    net = np.concatenate(global_feat, axis=2)
    net = net.reshape(net.shape[0], -1)
    net = _pointwise(net, params["fc1"], stats["fc1"], cfg.with_bn)
    net = _pointwise(net, params["fc2"], stats["fc2"], cfg.with_bn)
    return _pointwise(net, params["logits"], {}, False, activation=False)


def forward_scene_seg(variables, cfg, points):
    """NumPy eval-mode forward of SPH3DSceneSeg (f32; a ``spatial_sort``
    config on a cloud already sorted, see the module docstring). Mirrors
    models/segmentation.py (ref models/SPH3D_s3dis.py:35-113)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    points = np.asarray(points, np.float32)
    assert cfg.compute_dtype == "float32"
    bb_p, bb_s = params["backbone"], stats["backbone"]
    num_levels = len(cfg.radius)

    xyz = points[:, :, 0:3]
    norm_xyz = normalize_xy_center_z_floor(xyz) if cfg.normalize else xyz
    net = np.concatenate((norm_xyz, points[:, :, 6:]), axis=2)

    net = _pointwise(net, bb_p["mlp1"], bb_s["mlp1"], cfg.with_bn)

    xyz_layers = [xyz]
    encoder = []
    for level in range(num_levels):
        nn_index, nn_count, nn_dist = sphere_neighbor(
            xyz, xyz, cfg.radius[level], cfg.nn_uplimit[level], grow=False
        )
        bins = spherical_kernel(
            xyz, xyz, nn_index, nn_count, nn_dist, cfg.radius[level],
            cfg.kernel,
        )
        name = f"conv{level + 1}"
        net = _conv_block(net, bb_p[name], bb_s[name],
                          (nn_index, nn_count), bins, cfg.channels[level],
                          cfg.with_bn)
        encoder.append(net)
        if cfg.num_sample[level] > 1:
            samp = _sample(cfg, cfg.num_sample[level], xyz)
            xyz = np.take_along_axis(xyz, samp[..., None], axis=1)
            xyz_layers.append(xyz)
            idx_s = np.take_along_axis(nn_index, samp[..., None], axis=1)
            cnt_s = np.take_along_axis(nn_count, samp, axis=1)
            net, _ = max_pool3d(net, idx_s, cnt_s)

    radius_r = cfg.radius[::-1]
    nn_uplimit_r = cfg.nn_uplimit[::-1]
    channels_r = cfg.channels[::-1]
    xyz_layers = xyz_layers[::-1]
    encoder = encoder[::-1]

    for level in range(num_levels):
        xyz_coarse = xyz_layers[level]
        xyz_fine = xyz_layers[level + 1]
        ii, ic, idist = sphere_neighbor(
            xyz_coarse, xyz_coarse, radius_r[level], nn_uplimit_r[level],
            grow=False,
        )
        bins = spherical_kernel(
            xyz_coarse, xyz_coarse, ii, ic, idist, radius_r[level],
            cfg.kernel,
        )
        name = f"deconv{level + 1}"
        net = _conv_block(net, bb_p[name], bb_s[name], (ii, ic), bins,
                          channels_r[level], cfg.with_bn)
        ui, uc, ud = sphere_neighbor(
            xyz_coarse, xyz_fine, radius_r[level], nn_uplimit_r[level]
        )
        if cfg.unpool_method == "weighted":
            eps = np.float32(1e-7)
            valid = (
                np.arange(ud.shape[-1])[None, None, :] < uc[..., None]
            )
            ud = np.where(valid, ud, 0.0)
            w = (ud + eps) / (ud.sum(axis=-1, keepdims=True) + eps)
            net = weighted_interpolate(net, w, ui, uc)
        else:
            net = mean_interpolate(net, ui, uc)
        net = np.concatenate((net, encoder[level]), axis=2)

    return _pointwise(net, params["logits"], {}, False, activation=False)
