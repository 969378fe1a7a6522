"""Kernel dispatch of the PyTorch port, the eval entry, and the import
rule.

On the CPU every op runs its plain version; a wrapper asked for its
CUDA kernel with a CPU tensor raises (nothing is built, nothing falls
back). The port and a CPU forward leave JAX and the JAX package
unimported. The call recorder sees exactly the main path's calls. Tests marked
``cuda`` compare each kernel with its plain version on a card and skip
where there is none (run them on the card with
``python -m pytest tests/test_torch_dispatch.py -m cuda``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
from sph3d_gcn_torch.configs import modelnet_config, s3dis_config
from sph3d_gcn_torch.data.synthetic import scene_blocks
from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
from sph3d_gcn_torch.models.common import classic_clone
from sph3d_gcn_torch.ops import dense as D
from sph3d_gcn_torch.ops import query as Q
from sph3d_gcn_torch.ops import sample as S
from sph3d_gcn_torch.ops import windowed as W
from sph3d_gcn_torch.train.eval import (
    checked_forward,
    coverage_eval_blocks,
    vote_classify,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(n=512, b=2, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    return v[:, np.argsort(v[0, :, 0], kind="stable")]


def _scene_config(**kw):
    """S3DIS at N=1024 with windows that cover ``scene_blocks`` there."""
    kw = dict(dict(windows=(768, 512, 256, 128), dec_windows=(512,) * 4,
                   growth_steps=12, dec_margin=384), **kw)
    return dataclasses.replace(
        s3dis_config(num_input=1024, fast=True, dense=True), **kw)


def _growth_plan(pts, device="cpu"):
    """A decoder inter graph's query plan: fine points search every
    third point of their cloud, with radius growth."""
    t = torch.from_numpy(pts).to(device)
    return D.plan_dense_query(t[:, ::3].contiguous(), t, 0.01, None, 512,
                              growth_steps=12)


def _graphs(pts, device="cpu"):
    t = torch.from_numpy(pts).to(device)
    intra = D.build_dense_graph(t, t, 0.25, 16, (8, 2, 2), window=256,
                                self_graph=True, use_kernels=False)
    pool = D.build_dense_graph(t, t[:, ::4], 0.25, 16, None, window=384,
                               use_kernels=False)
    return t, intra, pool


def test_forced_kernel_on_cpu_raises_before_any_build():
    pts = _cloud()
    t, intra, pool = _graphs(pts)
    feats = torch.randn(2, 512, 64)
    filt = torch.randn(33, 64, 1)
    plan = D.plan_dense_query(t, t, 0.25, (8, 2, 2), 256)
    gplan = _growth_plan(pts)
    gargs = (gplan.db_p, gplan.q_p, gplan.s_blk, gplan.u_end)
    gkw = dict(radius=0.01, k=16, window=gplan.window, growth_steps=12)
    nbr = torch.zeros(2, 100, 16, dtype=torch.int64)
    cnt = torch.full((2, 100), 16)
    calls = [
        lambda: W.windowed_gather_padded(feats, nbr, cnt, window=256,
                                         use_kernels=True),
        lambda: W.window_gather_kernel(feats, nbr, cnt),
        lambda: W.window_gather_bwd_kernel(
            torch.zeros(2, 128, 16, 64), *W.edge_lists(nbr, cnt, 512), 512),
        lambda: Q.growth_query(*gargs, **gkw, use_kernels=True),
        lambda: Q.growth_query_kernel(*gargs, **gkw),
        lambda: Q.growth_query(*gargs, **gkw, need_dist=True,
                               use_kernels=True),
        lambda: Q.dense_query_kernel(plan.db_p, plan.q_p, plan.s_blk,
                                     plan.u_end, plan.axis, radius=0.25,
                                     k=16, kernel=(8, 2, 2), window=256,
                                     need_dist=True),
        lambda: S.farthest_point_sample(8, t, use_kernels=True),
        lambda: Q.dense_query(plan.db_p, plan.q_p, plan.s_blk, plan.u_end,
                              plan.axis, radius=0.25, k=16, kernel=(8, 2, 2),
                              window=256, use_kernels=True),
        lambda: D.dense_depthwise_conv3d(feats, filt, intra,
                                         use_kernels=True),
        lambda: D.dense_max_pool3d(feats, pool, use_kernels=True),
        lambda: D.dense_max_pool3d(feats, pool, with_index=True,
                                   use_kernels=True),
        lambda: S.farthest_point_sample_kernel(8, t),
        lambda: D.rank_pool_kernel(pool.packed, pool.s_blk,
                                   D.pool_counts(pool), feats),
        lambda: D.dense_conv_bwd_kernel(
            intra.packed, intra.s_blk, feats,
            *D.conv_operands(feats, filt, intra),
            torch.zeros(2, intra.s_blk.shape[1] * 128, 64)),
        lambda: D.rank_pool_bwd_kernel(
            pool.s_blk, torch.zeros(2, 128, 64, dtype=torch.int32),
            torch.zeros(2, 128, 64), 512, pool.window),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _build._LIB is None          # no library was built or loaded
    assert set(kernel_launches().values()) == {0}


def test_cpu_default_is_the_plain_version():
    pts = _cloud()
    t, intra, pool = _graphs(pts)
    assert torch.equal(S.farthest_point_sample(64, t),
                       S.farthest_point_sample_plain(64, t))
    got = D.build_dense_graph(t, t, 0.25, 16, (8, 2, 2), window=256,
                              self_graph=True)
    assert torch.equal(got.packed, intra.packed)
    assert set(kernel_launches().values()) == {0}


def test_port_imports_no_jax():
    code = (
        "import sys, dataclasses, numpy as np, torch\n"
        "import sph3d_gcn_torch\n"
        "from sph3d_gcn_torch.configs import modelnet_config\n"
        "from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg\n"
        "from sph3d_gcn_torch.train.eval import checked_forward, "
        "vote_classify, coverage_eval_blocks\n"
        "from sph3d_gcn_torch.utils.convert import "
        "torch_state_dict_from_flax, flax_tree_from_torch\n"
        "from sph3d_gcn_torch.train.schedule import make_optimizer\n"
        "from sph3d_gcn_torch.train.steps import "
        "classification_step_factory, segmentation_step_factory\n"
        "cfg = dataclasses.replace(modelnet_config(num_input=512, fast=True,"
        " dense=True), windows=(512,))\n"
        "m = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))\n"
        "x = np.random.default_rng(0).standard_normal((2, 512, 3))\n"
        "v = vote_classify(checked_forward(m.eval(), 'cpu'), "
        "x.astype(np.float32), 2)\n"
        "assert v.shape == (2, 40) and np.isfinite(v).all()\n"
        "step = classification_step_factory(m, *make_optimizer("
        "m.parameters()), weight_decay=1e-5)\n"
        "out = step.train_step({'points': torch.from_numpy("
        "x.astype(np.float32)), 'label': torch.tensor([1, 2])}, "
        "torch.Generator().manual_seed(0))\n"
        "assert torch.isfinite(out['loss'])\n"
        "w = SPH3DModelNet(modelnet_config(num_input=512, fast=True))\n"
        "assert np.isfinite(vote_classify(checked_forward(w.eval(), 'cpu'),"
        " x.astype(np.float32), 1)).all()\n"
        "import sph3d_gcn_torch.data.tfrecord, sph3d_gcn_torch.data.datasets\n"
        "import sph3d_gcn_torch.data.augment, sph3d_gcn_torch.train.metrics\n"
        "import sph3d_gcn_torch.train.augment_policies\n"
        "import sph3d_gcn_torch.train.checkpoint, sph3d_gcn_torch.train.loop\n"
        "import sph3d_gcn_torch.train.profiling\n"
        "import sph3d_gcn_torch.utils.windows\n"
        "from sph3d_gcn_torch.cli import train_modelnet, evaluate_modelnet, "
        "train_scene_seg, measure_windows, evaluate_scene_seg, "
        "aggregate_folds, train_shapenet, evaluate_shapenet\n"
        "assert all(callable(c.main) for c in (train_modelnet, "
        "evaluate_modelnet, train_scene_seg, measure_windows, "
        "evaluate_scene_seg, aggregate_folds, train_shapenet, "
        "evaluate_shapenet))\n"
        "import sph3d_gcn_torch.data.merge, sph3d_gcn_torch.data.prep.voxelize\n"
        "import sph3d_gcn_torch.data.prep.scannet\n"
        "import sph3d_gcn_torch.data.prep.shapenet\n"
        "from sph3d_gcn_torch.configs import shapenet_config, "
        "ruemonge2014_config\n"
        "from sph3d_gcn_torch.models import SPH3DShapeNet, "
        "SPH3DShapeNetOnehot, SPH3DRueMonge\n"
        "from sph3d_gcn_torch.train.eval import coverage_eval_block, "
        "shapenet_eval_augment\n"
        "sc = dataclasses.replace(shapenet_config(fast=True, dense=True), "
        "num_input=256, num_sample=(128, 96, 48, 16), windows=(256,) * 4, "
        "dec_windows=(256,) * 4, dec_margin=256, growth_steps=12)\n"
        "s = SPH3DShapeNetOnehot(sc, generator=torch.Generator()"
        ".manual_seed(0)).eval()\n"
        "from sph3d_gcn_torch.data.synthetic import surface_clouds\n"
        "p = surface_clouds(np.random.default_rng(1), 2, 300)\n"
        "blocks = [(p[0], np.ones(300, np.int32)), (p[1], np.ones(300, "
        "np.int32))]\n"
        "out = coverage_eval_blocks(checked_forward(s, 'cpu', model_inputs="
        "lambda ids: [np.array([3, 7])[ids]]), blocks, 256, 2, min_count=2, "
        "augment_fn=shapenet_eval_augment)\n"
        "assert all(o.shape == (300, 50) and np.isfinite(o).all() "
        "for o in out)\n"
        "SPH3DShapeNet(sc, 4), SPH3DRueMonge(ruemonge2014_config(1024))\n"
        "from sph3d_gcn_torch.utils.windows import measure_requirements\n"
        "measure_requirements(modelnet_config(512), x.astype(np.float32), "
        "device='cpu')\n"
        "import sph3d_gcn_torch.data.native_loader, "
        "sph3d_gcn_torch.data.raw_trees\n"
        "from sph3d_gcn_torch.data.prep import blocks, modelnet, ply, "
        "ruemonge, scannet, shapenet, voxelize\n"
        "xyz, _ = modelnet.prepare_shape(x[0].astype(np.float32), None, 256, "
        "device='cpu')\n"
        "assert xyz.shape == (256, 3)\n"
        "from sph3d_gcn_torch.cli import prepare_modelnet, prepare_s3dis, "
        "prepare_scannet, prepare_shapenet, prepare_ruemonge2014\n"
        "assert all(callable(c.main) for c in (prepare_modelnet, "
        "prepare_s3dis, prepare_scannet, prepare_shapenet, "
        "prepare_ruemonge2014))\n"
        "from sph3d_gcn_torch.utils import tf1_bundle, checkpoint_convert\n"
        "assert checkpoint_convert.tf_name('conv1._2.bn.mean') == "
        "'conv1_2/bn/moving_mean'\n"
        "from sph3d_gcn_torch.ops import build_cube_neighbor, "
        "CubeNeighborhood\n"
        "t = torch.from_numpy(x[:1].astype(np.float32))\n"
        "assert isinstance(build_cube_neighbor(t, t[:, :8], 0.5, 4), "
        "CubeNeighborhood)\n"
        "from sph3d_gcn_torch.ops import costs\n"
        "from sph3d_gcn_torch.utils import numpy_reference\n"
        "from sph3d_gcn_torch.cli import parity_check, profile_step\n"
        "assert callable(parity_check.main) and callable(profile_step.main)\n"
        "import sph3d_gcn_torch.parallel\n"
        "from sph3d_gcn_torch.parallel import launch, mesh, run_ranks, "
        "shard_batch, process_shard_files, local_batch_size\n"
        "assert process_shard_files(['a', 'b']) == ['a', 'b']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'sph3d_gcn_tpu', 'bench', "
        "'scripts', 'numpy_reference'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_record_calls_sees_every_wrapped_call_of_a_forward():
    cfg = dataclasses.replace(modelnet_config(fast=True, dense=True),
                              num_input=1024, num_sample=(256, 64, 16),
                              windows=(512, 256, 128))
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_cloud(n=1024, seed=3))
    with _build.record_calls() as calls, torch.no_grad():
        ref = model.eval()(x)
    assert [name for name, _, _ in calls] == [
        "dense_query", "fps", "dense_conv", "dense_conv", "dense_query",
        "rank_pool"] * 3
    assert _build._RECORD is None
    plain = {"fps": S.farthest_point_sample_plain,
             "dense_query": Q.dense_query_plain,
             "dense_conv": D.dense_conv_plain,
             "rank_pool": D.rank_pool_plain}
    for name, args, kw in calls:        # the operands replay as recorded
        plain[name](*args, **kw)
    with torch.no_grad():               # nothing is recorded outside
        assert torch.equal(model(x), ref)
    assert len(calls) == 18


def test_record_calls_sees_the_backward_calls_of_a_train_step():
    """A train-mode forward and backward records each conv and pool once
    forward (the pool with its argmax) and once backward, and every
    backward call replays through its plain version to the gradient the
    step computed."""
    cfg = dataclasses.replace(modelnet_config(fast=True, dense=True),
                              num_input=1024, num_sample=(256, 64, 16),
                              windows=(512, 256, 128))
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_cloud(n=1024, seed=3))
    with _build.record_calls() as calls:
        model.train()(x, generator=torch.Generator().manual_seed(1)).sum(
        ).backward()
    names = [name for name, _, _ in calls]
    assert names[:18] == ["dense_query", "fps", "dense_conv", "dense_conv",
                          "dense_query", "rank_pool"] * 3
    assert sorted(names[18:]) == ["dense_conv_bwd"] * 6 + ["rank_pool_bwd"] * 3
    assert all(kw == {"with_arg": True} for name, _, kw in calls
               if name == "rank_pool")
    for name, args, kw in calls[18:]:
        plain = (D.dense_conv_bwd_plain if name == "dense_conv_bwd"
                 else D.rank_pool_bwd_plain)
        out = plain(*args)
        out = out if isinstance(out, tuple) else (out,)
        assert all(torch.isfinite(o.float()).all() for o in out)
    assert set(kernel_launches().values()) == {0}


def test_record_calls_sees_every_wrapped_call_of_a_scene_forward():
    model = SPH3DSceneSeg(_scene_config(),
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(scene_blocks(np.random.default_rng(0), 2, 1024))
    with _build.record_calls() as calls, torch.no_grad():
        model.eval()(x)
    names = [name for name, _, _ in calls]
    enc = ["dense_query", "fps", "dense_conv", "dense_conv", "dense_query",
           "rank_pool"]
    dec = ["dense_query", "growth_query", "dense_conv", "dense_conv",
           "mean_interpolate"]
    assert names == enc * 4 + dec * 4
    assert bool(model.dense_ok)
    assert set(kernel_launches().values()) == {0}


def test_scene_blocks_served_through_coverage_eval():
    """Blocks of more and fewer points than the model takes, served on the
    CPU through the checked forward: every inner point covered, finite
    logits in block order. A model whose decoder windows miss the grown
    radii serves a block of exactly its 1024 points (covered in one
    forward: a resample without replacement) through the per-edge
    fallback, equal to a direct per-edge forward."""
    model = SPH3DSceneSeg(_scene_config(),
                          generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(2)
    blocks = []
    for p in (1500, 800, 1100):
        pts = scene_blocks(rng, 1, p)[0]
        inner = ((pts[:, :2] > 0.3) & (pts[:, :2] < 1.2)).all(-1)
        blocks.append((pts, inner.astype(np.int32)))
    sums = coverage_eval_blocks(checked_forward(model, "cpu"), blocks, 1024,
                                2, rng=np.random.default_rng(3))
    for (pts, inner), logits in zip(blocks, sums):
        assert logits.shape == (len(pts), 13)
        assert np.isfinite(logits).all()
        assert (np.abs(logits[inner == 1]).sum(-1) > 0).all()
    tight = SPH3DSceneSeg(_scene_config(dec_margin=0, growth_steps=1),
                          generator=torch.Generator().manual_seed(0)).eval()
    checked, clone = checked_forward(tight, "cpu"), classic_clone(tight)
    fell = []

    def forward(points, block_ids=None):
        logits = checked(points)
        fell.append(not bool(tight.dense_ok))
        with torch.no_grad():
            direct = clone(torch.from_numpy(points))
        np.testing.assert_array_equal(logits, direct.numpy())
        return logits

    pts = scene_blocks(rng, 1, 1024)[0]
    inner = ((pts[:, :2] > 0.3) & (pts[:, :2] < 1.2)).all(-1)
    (logits,) = coverage_eval_blocks(forward, [(pts, inner.astype(
        np.int32))], 1024, 1, rng=np.random.default_rng(3))
    assert fell == [True]
    assert logits.shape == (1024, 13) and np.isfinite(logits).all()
    assert (np.abs(logits[inner]).sum(-1) > 0).all()


def _windowed_config(n=1024):
    """The per-edge engine of ``modelnet_config(fast=True)`` at a test
    size (windows 512/256/128)."""
    return dataclasses.replace(modelnet_config(fast=True), num_input=n,
                               num_sample=(256, 64, 16),
                               windows=(512, 256, 128))


def test_record_calls_sees_the_windowed_engine_calls():
    """Per level of the per-edge engine: FPS, two conv gathers and the
    pool gather (K1 3, K8 9 per forward); a train-mode backward adds one
    K9 per gather. Every call replays through its plain version to what
    the run computed."""
    model = SPH3DModelNet(_windowed_config(),
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_cloud(n=1024, seed=3))
    with _build.record_calls() as calls, torch.no_grad():
        model.eval()(x)
    assert [name for name, _, _ in calls] == [
        "fps", "window_gather", "window_gather", "window_gather"] * 3
    for name, args, kw in calls[1:4]:
        assert W.window_gather_plain(*args, **kw).shape[1] % 128 == 0
    with _build.record_calls() as calls:
        model.train()(x, generator=torch.Generator().manual_seed(1)).sum(
        ).backward()
    names = [name for name, _, _ in calls]
    assert names[:12] == ["fps", "window_gather", "window_gather",
                          "window_gather"] * 3
    assert names[12:] == ["window_gather_bwd"] * 9
    # one set of inverse edge lists per neighborhood: a level's two convs
    # share theirs, each pool has its own
    orders = [args[1] for _, args, _ in calls[12:]]
    assert len({id(o) for o in orders}) == 6
    assert orders[0] is not orders[1] and orders[1] is orders[2]
    first = model.mlp1.weights.grad
    assert first is not None and torch.isfinite(first).all()
    for _, args, _ in calls[12:]:
        dx = W.window_gather_bwd_plain(*args)
        assert dx.shape[1] == args[3] and torch.isfinite(dx.float()).all()
    assert set(kernel_launches().values()) == {0}


def test_segment_sum_plain_versions_add_in_list_order():
    """K9's plain twin adds each row's edges in list order: bitwise the
    sequential ``index_add_`` of the CPU. The unpool backward's plain
    version, whose cloud sum is that twin, within f32 rounding of the
    scatter-add that autograd of its window gather would run."""
    rng = np.random.default_rng(5)
    n, m, k = 700, 300, 16
    base = np.sort(rng.integers(0, n, (3, m)))
    idx = torch.from_numpy(np.clip(
        base[..., None] + rng.integers(-40, 40, (3, m, k)), 0, n - 1))
    cnt = torch.from_numpy(rng.integers(0, k + 1, (3, m)))
    order, starts = W.edge_lists(idx, cnt, n)
    gen = torch.Generator().manual_seed(4)
    dg = torch.randn(3, 384, k, 35, generator=gen)
    n_valid = int(starts[-1])
    target = torch.repeat_interleave(torch.arange(3 * n), starts.diff())
    ref = torch.zeros(3 * n, 35).index_add_(
        0, target, dg.reshape(-1, 35)[order[:n_valid].long()])
    assert torch.equal(W.window_gather_bwd_plain(dg, order, starts, n),
                       ref.reshape(3, n, 35))

    _, _, pool = _graphs(_cloud(n=700, b=3, seed=2))
    dout = torch.randn(3, pool.s_blk.shape[1] * 128, 64, generator=gen)
    got = D.window_mean_bwd(pool.packed, pool.s_blk, dout, 700)
    rows, valid, b_of_g = D._window_rows(pool.packed, pool.s_blk, 700)
    mask = (pool.packed > 0).reshape(-1, 128, pool.window).float()
    dfw = torch.einsum("gtw,gtc->gwc", mask, dout.reshape(-1, 128, 64))
    ref = torch.zeros(3 * 700, 64).index_put_(
        ((b_of_g[:, None] * 700 + rows)[valid],), dfw[valid],
        accumulate=True)
    torch.testing.assert_close(got, ref.reshape(3, 700, 64), rtol=1e-5,
                               atol=1e-5)


def fallback_case():
    """A dense ModelNet model whose windows (128 rows) are too small for
    its clouds, and those clouds."""
    cfg = dataclasses.replace(modelnet_config(num_input=512, fast=True,
                                              dense=True), windows=(128,))
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    pts = np.random.default_rng(1).standard_normal((2, 512, 3)).astype(
        np.float32)
    return model.eval(), pts


def test_eval_entry_falls_back_on_failed_certificate(capsys):
    """A failed certificate no longer raises: ``checked_forward`` re-runs
    the batch on the classic per-edge engine (``classic_clone``, same
    parameters) and returns its logits (which equal the JAX package's
    classic engine on the same weights: tests/test_torch_windowed.py).
    One line is printed, the first time only. The card's run of this
    path is ``chip_smoke.py``'s vote serving on the default windows."""
    model, pts = fallback_case()
    with torch.no_grad():
        model(torch.from_numpy(pts))
    assert not bool(model.dense_ok)
    forward = checked_forward(model, "cpu")
    got = vote_classify(forward, pts, 1)
    assert capsys.readouterr().out.count("classic per-edge engine") == 1
    forward(pts)
    assert capsys.readouterr().out == ""
    clone = classic_clone(model)
    assert clone.conv1 is model.conv1 and not clone.config.dense_graph
    assert model.config.dense_graph
    with torch.no_grad():
        ref = clone(torch.from_numpy(pts)).numpy()
    assert bool(clone.dense_ok)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_cuda(cuda_device, dtype):
    pts = _cloud(n=700, b=3, seed=2)
    t, intra, pool = _graphs(pts, cuda_device)
    assert torch.equal(S.farthest_point_sample_kernel(100, t),
                       S.farthest_point_sample_plain(100, t))
    for db, q, kernel, w in ((t, t, (8, 2, 2), 256), (t, t[:, ::4], None,
                                                       384)):
        plan = D.plan_dense_query(db, q, 0.25, kernel, w)
        args = (plan.db_p, plan.q_p, plan.s_blk, plan.u_end, plan.axis)
        kw = dict(radius=0.25, k=16, kernel=kernel, window=plan.window)
        got, ref = (Q.dense_query_kernel(*args, **kw),
                    Q.dense_query_plain(*args, **kw))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for c, mult in ((35, 2), (131, 1)):
        x = torch.randn(3, 700, c, device=cuda_device).to(dtype)
        filt_b, inv = D.conv_operands(
            x, torch.randn(33, c, mult, device=cuda_device), intra)
        a = (intra.packed, intra.s_blk, x, filt_b, inv)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(D.dense_conv_kernel(*a).float(),
                                   D.dense_conv_plain(*a).float(),
                                   rtol=tol, atol=tol)
    x = torch.randn(3, 700, 64, device=cuda_device).to(dtype)
    a = (pool.packed, pool.s_blk, D.pool_counts(pool), x)
    assert torch.equal(D.rank_pool_kernel(*a), D.rank_pool_plain(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_on_cuda(cuda_device, dtype):
    """K5 (conv backward) within f32 sum-order tolerance (dx one rounding
    in bf16; dfilt relative to its largest magnitude), run twice to the
    same bits; K4's argmax and K6 (pool backward) exactly, on integer
    features with ties and -0."""
    pts = _cloud(n=700, b=3, seed=2)
    t, intra, pool = _graphs(pts, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for c, mult in ((35, 2), (64, 1), (131, 1)):
        x = torch.randn(3, 700, c, device=cuda_device, generator=gen).to(
            dtype)
        filt_b, inv = D.conv_operands(
            x, torch.randn(33, c, mult, device=cuda_device, generator=gen),
            intra)
        dout = torch.randn(3, intra.s_blk.shape[1] * 128, c * mult,
                           device=cuda_device, generator=gen).to(dtype)
        a = (intra.packed, intra.s_blk, x, filt_b, inv, dout)
        dx, dfilt = D.dense_conv_bwd_kernel(*a)
        dx_p, dfilt_p = D.dense_conv_bwd_plain(*a)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(dx.float(), dx_p.float(), rtol=tol,
                                   atol=tol * dx_p.abs().max().item())
        torch.testing.assert_close(dfilt, dfilt_p, rtol=1e-5,
                                   atol=1e-5 * dfilt_p.abs().max().item())
        dx2, dfilt2 = D.dense_conv_bwd_kernel(*a)
        assert torch.equal(dx, dx2) and torch.equal(dfilt, dfilt2)
    for c in (64, 128):
        x = torch.randint(-3, 4, (3, 700, c), device=cuda_device,
                          generator=gen).float()
        x = torch.where((x == 0) & (torch.rand(x.shape, device=cuda_device,
                                               generator=gen) < 0.5),
                        -0.0, x).to(dtype)
        a = (pool.packed, pool.s_blk, D.pool_counts(pool), x)
        out, arg = D.rank_pool_kernel(*a, with_arg=True)
        out_p, arg_p = D.rank_pool_plain(*a, with_arg=True)
        assert torch.equal(out, out_p) and torch.equal(arg, arg_p)
        assert torch.equal(out, D.rank_pool_kernel(*a))
        dout = torch.randint(-4, 5, out.shape, device=cuda_device,
                             generator=gen).to(dtype)
        b = (pool.s_blk, arg, dout, 700, pool.window)
        assert torch.equal(D.rank_pool_bwd_kernel(*b),
                           D.rank_pool_bwd_plain(*b))


@pytest.mark.cuda
def test_growth_kernel_matches_plain_on_cuda(cuda_device):
    """K7: maps and per-row steps exactly, at several growth depths, and
    the graph build through it."""
    pts = _cloud(n=2000, b=3, seed=4)
    plan = _growth_plan(pts, cuda_device)
    args = (plan.db_p, plan.q_p, plan.s_blk, plan.u_end)
    for steps in (1, 3, 12, 15):
        kw = dict(radius=0.01, k=16, window=plan.window, growth_steps=steps)
        got, got_steps, got_count, _ = Q.growth_query_kernel(*args, **kw)
        ref, ref_steps, ref_count, _ = Q.growth_query_plain(*args, **kw)
        assert torch.equal(got, ref) and torch.equal(got_steps, ref_steps)
        assert torch.equal(got_count, ref_count)
        assert int(ref_steps.max()) > 0
    t = torch.from_numpy(pts).to(cuda_device)
    db = t[:, ::3].contiguous()
    g_k = D.build_dense_graph(db, t, 0.01, 16, None, window=512,
                              growth_steps=12)
    g_p = D.build_dense_graph(db, t, 0.01, 16, None, window=512,
                              growth_steps=12, use_kernels=False)
    assert torch.equal(g_k.packed, g_p.packed)
    assert bool(g_k.ok) == bool(g_p.ok)


@pytest.mark.cuda
def test_dist_map_kernels_match_plain_on_cuda(cuda_device):
    """K2 (rank, grouped-bin and ungrouped-bin maps) and K7 (growth depths
    3 and 12) with ``need_dist``: the f32 distance map bitwise equal to the
    plain version's, and the packed maps and growth steps bitwise equal to
    the same launch without the map. On a CUDA tensor the wrapper
    launches the kernel (its count goes up) and takes the plain version
    only with ``use_kernels=False``."""
    pts = _cloud(n=700, b=3, seed=2)
    t = torch.from_numpy(pts).to(cuda_device)
    for db, q, kernel, w, grouped in (
            (t, t, (8, 2, 2), 256, True), (t, t, (8, 2, 2), 256, False),
            (t, t[:, ::4], None, 384, False)):
        plan = D.plan_dense_query(db, q, 0.25, kernel, w)
        args = (plan.db_p, plan.q_p, plan.s_blk, plan.u_end,
                plan.axis if grouped else None)
        kw = dict(radius=0.25, k=16, kernel=kernel, window=plan.window)
        packed, _, dist = Q.dense_query_kernel(*args, **kw, need_dist=True)
        ref, _, ref_dist = Q.dense_query_plain(*args, **kw, need_dist=True)
        assert torch.equal(packed, ref) and torch.equal(dist, ref_dist)
        assert Q.dense_query_kernel(*args, **kw)[2] is None
        assert torch.equal(packed, Q.dense_query_kernel(*args, **kw)[0])
        assert (dist[packed == 0] == 0).all() and (dist > 0).any()
        reset_kernel_launches()
        Q.dense_query(*args, **kw, need_dist=True)
        assert kernel_launches()["dense_query"] == 1
        Q.dense_query(*args, **kw, need_dist=True, use_kernels=False)
        assert kernel_launches()["dense_query"] == 1
    gplan = _growth_plan(pts, cuda_device)
    gargs = (gplan.db_p, gplan.q_p, gplan.s_blk, gplan.u_end)
    for steps in (3, 12):
        kw = dict(radius=0.01, k=16, window=gplan.window, growth_steps=steps)
        got = Q.growth_query_kernel(*gargs, **kw, need_dist=True)
        ref = Q.growth_query_plain(*gargs, **kw, need_dist=True)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        alone = Q.growth_query_kernel(*gargs, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got[:3], alone[:3]))
        assert alone[3] is None
        reset_kernel_launches()
        Q.growth_query(*gargs, **kw, need_dist=True)
        assert kernel_launches()["growth_query"] == 1
    # the graph build and the ops that read the map, through the kernels
    db = t[:, ::3].contiguous()
    g_k = D.build_dense_graph(db, t, 0.01, 16, None, window=512,
                              growth_steps=12, need_dist=True)
    g_p = D.build_dense_graph(db, t, 0.01, 16, None, window=512,
                              growth_steps=12, need_dist=True,
                              use_kernels=False)
    assert torch.equal(g_k.dist, g_p.dist)
    x = torch.randn(3, db.shape[1], 64, device=cuda_device,
                    requires_grad=True)
    reset_kernel_launches()
    D.dense_weighted_interpolate(x, g_k).sum().backward()
    assert kernel_launches()["window_gather_bwd"] == 1
    grad = x.grad.clone()
    x.grad = None
    D.dense_weighted_interpolate(x, g_p, use_kernels=False).sum().backward()
    assert torch.equal(grad, x.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_conv_and_pool_kernels_match_plain_on_cuda(cuda_device, dtype):
    """K3 at the S3DIS widths C_in = 512 and 1024 (r = 2), K4 at C = 512
    (values and first attaining column)."""
    pts = _cloud(n=700, b=3, seed=2)
    t, intra, pool = _graphs(pts, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for c in (512, 1024):
        x = torch.randn(3, 700, c, device=cuda_device, generator=gen).to(dtype)
        filt_b, inv = D.conv_operands(
            x, torch.randn(33, c, 2, device=cuda_device, generator=gen),
            intra)
        a = (intra.packed, intra.s_blk, x, filt_b, inv)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(D.dense_conv_kernel(*a).float(),
                                   D.dense_conv_plain(*a).float(),
                                   rtol=tol, atol=tol)
    x = torch.randn(3, 700, 512, device=cuda_device, generator=gen).to(dtype)
    a = (pool.packed, pool.s_blk, D.pool_counts(pool), x)
    assert torch.equal(D.rank_pool_kernel(*a), D.rank_pool_plain(*a))
    out, arg = D.rank_pool_kernel(*a, with_arg=True)
    out_p, arg_p = D.rank_pool_plain(*a, with_arg=True)
    assert torch.equal(out, out_p) and torch.equal(arg, arg_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_backward_kernels_match_plain_on_cuda(cuda_device, dtype):
    """K5 at the S3DIS widths C_in = 512 and 1024 (r = 2, 64-channel
    chunks) within f32 sum-order tolerance, K6 at C = 512 (two chunks)
    exactly on integer features; each run twice to the same bits."""
    pts = _cloud(n=700, b=3, seed=2)
    t, intra, pool = _graphs(pts, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for c in (512, 1024):
        x = torch.randn(3, 700, c, device=cuda_device, generator=gen).to(
            dtype)
        filt_b, inv = D.conv_operands(
            x, torch.randn(33, c, 2, device=cuda_device, generator=gen),
            intra)
        dout = torch.randn(3, intra.s_blk.shape[1] * 128, 2 * c,
                           device=cuda_device, generator=gen).to(dtype)
        a = (intra.packed, intra.s_blk, x, filt_b, inv, dout)
        dx, dfilt = D.dense_conv_bwd_kernel(*a)
        dx_p, dfilt_p = D.dense_conv_bwd_plain(*a)
        torch.testing.assert_close(dx.float(), dx_p.float(), rtol=tol,
                                   atol=tol * dx_p.abs().max().item())
        torch.testing.assert_close(dfilt, dfilt_p, rtol=1e-5,
                                   atol=1e-5 * dfilt_p.abs().max().item())
        dx2, dfilt2 = D.dense_conv_bwd_kernel(*a)
        assert torch.equal(dx, dx2) and torch.equal(dfilt, dfilt2)
    x = torch.randint(-3, 4, (3, 700, 512), device=cuda_device,
                      generator=gen).to(dtype)
    a = (pool.packed, pool.s_blk, D.pool_counts(pool), x)
    out, arg = D.rank_pool_kernel(*a, with_arg=True)
    dout = torch.randint(-4, 5, out.shape, device=cuda_device,
                         generator=gen).to(dtype)
    b = (pool.s_blk, arg, dout, 700, pool.window)
    dx = D.rank_pool_bwd_kernel(*b)
    assert torch.equal(dx, D.rank_pool_bwd_plain(*b))
    assert torch.equal(dx, D.rank_pool_bwd_kernel(*b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_index_kernels_match_plain_on_cuda(cuda_device, dtype):
    """``dense_max_pool3d(with_index=True)`` through K4 (and K6 for its
    gradient) equal to the plain versions, on a rank map and a bin map,
    at inference and in training."""
    pts = _cloud(n=700, b=3, seed=2)
    t, intra, pool = _graphs(pts, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for g, c in ((pool, 64), (pool, 512), (intra, 128)):
        x = torch.randint(-3, 4, (3, 700, c), device=cuda_device,
                          generator=gen).to(dtype)
        with torch.no_grad():
            got = D.dense_max_pool3d(x, g, with_index=True)
            ref = D.dense_max_pool3d(x, g, with_index=True,
                                     use_kernels=False)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        cot = torch.randint(-4, 5, got[0].shape, device=cuda_device,
                            generator=gen).to(dtype)
        grads = []
        for use in (None, False):
            xg = x.clone().requires_grad_()
            out, idx = D.dense_max_pool3d(xg, g, with_index=True,
                                          use_kernels=use)
            assert torch.equal(idx, ref[1])
            out.backward(cot)
            grads.append(xg.grad)
        assert torch.equal(*grads)


@pytest.mark.cuda
def test_unpool_backward_kernel_matches_plain_on_cuda(cuda_device):
    """The masked-mean unpool's backward, its cloud sum through K9,
    bitwise equal to its plain version (the same sums in the same list
    order) and to itself; one K9 launch per backward of the unpool."""
    pts = _cloud(n=700, b=3, seed=2)
    _, _, pool = _graphs(pts, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for c in (64, 512):
        dout = torch.randn(3, pool.s_blk.shape[1] * 128, c,
                           device=cuda_device, generator=gen)
        a = (pool.packed, pool.s_blk, dout, 700)
        dx = D.window_mean_bwd(*a)
        assert torch.equal(dx, D.window_mean_bwd(*a, use_kernels=False))
        assert torch.equal(dx, D.window_mean_bwd(*a))
    x = torch.randn(3, 700, 64, device=cuda_device, generator=gen,
                    requires_grad=True)
    reset_kernel_launches()
    D.dense_mean_interpolate(x.to(torch.bfloat16), pool).float().sum(
    ).backward()
    assert kernel_launches()["window_gather_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_gather_kernels_match_plain_on_cuda(cuda_device, dtype):
    """K8 bitwise equal to its plain version at the engine's widths (every
    copy unit: rows of 35 to 131 channels) and on a cloud-wide spread of
    indices; K9 within f32 sum-order tolerance (one rounding in bf16) and
    the same bits twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rng = np.random.default_rng(5)
    n, m, k = 700, 300, 16
    base = np.sort(rng.integers(0, n, (3, m)))
    idx = np.clip(base[..., None] + rng.integers(-40, 40, (3, m, k)), 0,
                  n - 1)
    idx[0, 0] = rng.integers(0, n, k)              # outside any window
    idx = torch.from_numpy(idx).to(cuda_device)
    cnt = torch.from_numpy(rng.integers(1, k + 1, (3, m))).to(cuda_device)
    order, starts = W.edge_lists(idx, cnt, n)
    for c in (35, 64, 67, 128, 131):
        x = torch.randn(3, n, c, device=cuda_device, generator=gen).to(dtype)
        got = W.window_gather_kernel(x, idx, cnt)
        assert torch.equal(got, W.window_gather_plain(x, idx, cnt))
        dg = torch.randn(got.shape, device=cuda_device, generator=gen).to(
            dtype)
        dx = W.window_gather_bwd_kernel(dg, order, starts, n)
        ref = W.window_gather_bwd_plain(dg, order, starts, n)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(dx.float(), ref.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(dx, W.window_gather_bwd_kernel(dg, order, starts,
                                                          n))


def _unpool_edges(rng, batch, n, m, k):
    """Fine queries (M of them) into a coarse cloud of N rows: each row's
    K lanes within 20 rows of its place in the coarse order, counts 1..K
    (a fine point always has a coarse neighbor, at a grown radius)."""
    base = (np.arange(m) * n) // m
    idx = np.clip(base[None, :, None] + rng.integers(-20, 20, (batch, m, k)),
                  0, n - 1)
    return idx, rng.integers(1, k + 1, (batch, m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpool_gathers_match_plain_on_cuda(cuda_device, dtype):
    """The per-edge unpools' gathers, fine rows from a coarse cloud (M =
    4N, no multiple of 128): K8 bitwise equal to its plain version, K9
    the same bits as its plain version (the same f32 sums in list order)
    and as itself; the mean and weighted unpools through them, one K8 and
    one K9 launch a call, equal to the plain versions forward and
    backward."""
    from sph3d_gcn_torch.ops.unpool import (
        mean_interpolate,
        weighted_interpolate,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rng = np.random.default_rng(6)
    n, m, k = 300, 1200, 64
    idx, cnt = (torch.from_numpy(a).to(cuda_device)
                for a in _unpool_edges(rng, 3, n, m, k))
    order, starts = W.edge_lists(idx, cnt, n)
    for c in (64, 128, 256):
        x = torch.randn(3, n, c, device=cuda_device, generator=gen).to(dtype)
        got = W.window_gather_kernel(x, idx, cnt)
        assert got.shape == (3, 1280, k, c)
        assert torch.equal(got, W.window_gather_plain(x, idx, cnt))
        dg = torch.randn(got.shape, device=cuda_device, generator=gen).to(
            dtype)
        dx = W.window_gather_bwd_kernel(dg, order, starts, n)
        assert torch.equal(dx, W.window_gather_bwd_plain(dg, order, starts,
                                                         n))
        assert torch.equal(dx, W.window_gather_bwd_kernel(dg, order, starts,
                                                          n))
    weight = torch.rand(3, m, k, device=cuda_device, generator=gen)
    x = torch.randn(3, n, 128, device=cuda_device, generator=gen).to(dtype)
    cot = torch.randn(3, m, 128, device=cuda_device, generator=gen).to(dtype)
    for op, extra in ((mean_interpolate, ()),
                      (weighted_interpolate, (weight,))):
        outs = []
        for use_kernels in (None, False):
            xg = x.clone().requires_grad_()
            reset_kernel_launches()
            out = op(xg, *extra, idx, cnt, window=128,
                     use_kernels=use_kernels)
            out.backward(cot)
            launches = kernel_launches()
            want = 1 if use_kernels is None else 0
            assert (launches["window_gather"],
                    launches["window_gather_bwd"]) == (want, want)
            outs.append((out.detach(), xg.grad))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
def test_unpool_gather_at_full_size_on_cuda(cuda_device):
    """The last decoder level of a S3DIS batch: 16 clouds of 8192 fine
    points gathering K = 64 of 2048 coarse rows of 128 bf16 channels
    (2.15 GB written), K8 bitwise equal to its plain version, K9 to its
    plain version and to itself."""
    rng = np.random.default_rng(7)
    n, m, k, c = 2048, 8192, 64, 128
    idx, cnt = (torch.from_numpy(a).to(cuda_device)
                for a in _unpool_edges(rng, 16, n, m, k))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(16, n, c, device=cuda_device, generator=gen).to(
        torch.bfloat16)
    got = W.window_gather_kernel(x, idx, cnt)
    assert got.shape == (16, m, k, c)
    assert torch.equal(got, W.window_gather_plain(x, idx, cnt))
    del got
    order, starts = W.edge_lists(idx, cnt, n)
    dg = torch.randn((16, m, k, c), device=cuda_device, generator=gen).to(
        torch.bfloat16)
    dx = W.window_gather_bwd_kernel(dg, order, starts, n)
    assert torch.equal(dx, W.window_gather_bwd_plain(dg, order, starts, n))
    assert torch.equal(dx, W.window_gather_bwd_kernel(dg, order, starts, n))


@pytest.mark.cuda
def test_fit_and_checkpoint_on_cuda(cuda_device, tmp_path):
    """``train.loop.fit`` of 3 steps of a dense classifier on the card
    (the step's kernels launched, its pre-step copy made each step, the
    loss finite, a failed certificate re-run through the per-edge
    engine), then a checkpoint round trip of the CUDA state: model,
    optimizer and scheduler bitwise equal after ``restore``."""
    from sph3d_gcn_torch.train.checkpoint import Checkpointer
    from sph3d_gcn_torch.train.loop import fit
    from sph3d_gcn_torch.train.schedule import make_optimizer
    from sph3d_gcn_torch.train.steps import classification_step_factory

    def factory(windows):
        cfg = dataclasses.replace(modelnet_config(1024, fast=True,
                                                  dense=True),
                                  windows=windows)
        model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(
            0)).to(cuda_device)
        return classification_step_factory(
            model, *make_optimizer(model.parameters()), weight_decay=1e-5)

    pts = _cloud(n=1024, b=6, seed=4)
    batches = [{"points": pts[i:i + 2], "label": np.array([1, 2])}
               for i in range(0, 6, 2)]
    trained = {}
    for windows, falls_back in (((1024,), False), ((128,), True)):
        f = trained[windows] = factory(windows)
        reset_kernel_launches()
        fit(f, lambda epoch: iter(batches), None, 2, 1,
            str(tmp_path / str(windows[0])), seed=1)
        log = (tmp_path / str(windows[0]) / "log_train.txt").read_text()
        assert ("re-running via the classic engine" in log) == falls_back
        launches = kernel_launches()
        assert launches["dense_conv"] >= 6 and launches["fps"] >= 3
        assert (launches["window_gather"] > 0) == falls_back
        assert f.scheduler.last_epoch == 3
    ref = trained[(1024,)]
    got = factory((1024,))
    Checkpointer(tmp_path / "1024").restore(got.model, got.optimizer,
                                            got.scheduler)
    want = ref.model.state_dict()
    for k, v in got.model.state_dict().items():
        assert v.is_cuda and torch.equal(v, want[k]), k
    for p, q in zip(got.model.parameters(), ref.model.parameters()):
        for k, v in ref.optimizer.state[q].items():
            assert torch.equal(got.optimizer.state[p][k], v), k
    assert got.scheduler.state_dict() == ref.scheduler.state_dict()
