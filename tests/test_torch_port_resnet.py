"""ResNet-50 in the PyTorch port (samrs_tpu_torch.seg.backbones.resnet) vs the
JAX package, on CPU in fp32 (train-mode gradients in float64).

A tiny ResNet (stages of 2 / 1 / 1 / 1 bottlenecks at the published widths,
64^2 images) runs on flax variables whose every leaf is drawn with numpy
(draw_variables), bridged with ``jax_params_to_torch`` and loaded strictly:
c1..c4, the gradients of a fixed random projection of them with respect to
every parameter, and the BatchNorm statistics (``_parity``, TOL 1e-4).  In
eval mode all of it in fp32.  In train mode each ReLU follows a BatchNorm
of batch statistics, and fp32 rounding decides the side of its kink for a
value within ~1e-6 of it: one such value in layer1 puts the fp32 gradients
1.2e-3 apart (flax's E[x^2] - E[x]^2 batch variance, which torch does not
use, adds its cancellation: 7e-3 under another draw).  So in train mode the
features and statistics are held in fp32, and the gradients with both sides
in float64 (``jax.enable_x64``; the port's model ``.double()``), where the
two agree within 1e-6 (the flax gradients come back in the parameters'
fp32).  Also:
JAX's ``.pth`` loader reads the port's state dict (torchvision's key
layout), the published model's parameters, per-block checkpointing with
the BatchNorm statistics updated once, the optimizer row (lr 1e-3 x global
batch / 96).  The whole SEP step is in test_torch_port_sep_backbones.py.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.core.config import PretrainConfig as JaxPretrainConfig
from samrs_tpu.seg.backbones import resnet as jax_resnet
from samrs_tpu.seg.port import load_torch_resnet_backbone
from samrs_tpu.train import optim as jax_optim
from samrs_tpu.train.pretrain import apply_optim_defaults as jax_apply_optim_defaults
from samrs_tpu_torch.core.config import PretrainConfig
from samrs_tpu_torch.seg.backbones import resnet
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.seg.registry import get_backbone
from samrs_tpu_torch.train import optim
from samrs_tpu_torch.train.pretrain import apply_optim_defaults
from test_torch_port_seg import draw_variables
from test_torch_port_vit_adapter import TOL, _assert_parity, _nchw, _parity, _port_names

SIZE = 64
TINY = dict(stage_sizes=(2, 1, 1, 1))  # every block kind: strided, with and without shortcut conv
N_STATS = 40  # 20 BatchNorms: the stem's, 4 + 3 in stage 1, 4 in each other stage


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The port's side of these tests (and of the Swin, ViTAE and SEP-step
    files, which import this fixture) on two intra-op threads: tiny models
    run thousands of small ops, and under the suite's parallel workers each
    op waits on all of its OpenMP threads, at eight ~15 times slower.
    Two give the results of four and eight (the ResNet step's gradients
    within 1e-6); one takes other code paths, whose rounding moves that
    step's gradients by 1e-2 at its ReLU kinks."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _resnet_parity(train, dtype=np.float32):
    x = _images(1).astype(dtype)
    jm = jax_resnet.ResNet(**TINY, dtype=jnp.dtype(dtype))
    pm = resnet.ResNet(**TINY).to(torch.from_numpy(x).dtype)
    return _parity(jm, (jnp.asarray(x), train), pm, lambda m, _: m(torch.from_numpy(x))[1:],
                   ["encoder"], "encoder.", 2, jout=lambda outs: _nchw(outs[1:]), train=train)


def test_resnet_matches_flax_in_eval_mode():
    """c1..c4 (64^2 -> 16^2 .. 2^2), every gradient and the 20 BatchNorms'
    running statistics (used, and left as they were), in fp32."""
    res = _resnet_parity(False)
    assert len(res["out"]) == 4 and len(res["grad"]) == 60
    _assert_parity(res, n_stats=N_STATS)


def test_resnet_features_and_batch_stats_match_flax_in_train_mode():
    """In train mode, fp32: c1..c4 on the batch statistics and the 20
    BatchNorms' running averages after the forward (momentum 0.9, the
    biased batch variance)."""
    res = _resnet_parity(True)
    assert max(res["out"]) <= TOL, res["out"]
    assert len(res["stats"]) == N_STATS
    worst = max(res["stats"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TOL, worst


def test_resnet_train_mode_gradients_match_flax_in_float64():
    """In train mode with both sides in float64 (away from fp32's rounding
    at the ReLU kinks): the features within 1e-12, every gradient within
    1e-6, the statistics within 1e-6."""
    with jax.enable_x64(True):
        res = _resnet_parity(True, np.float64)
    assert max(res["out"]) <= 1e-12, res["out"]
    assert len(res["grad"]) == 60 and len(res["stats"]) == N_STATS
    for what in ("grad", "stats"):
        worst = max(res[what].items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-6, (what, worst)


def test_resnet_per_block_checkpointing():
    """``use_checkpoint`` (``remat=True`` in the frameworks) recomputes each
    bottleneck in the backward: the same features and gradients, and every
    BatchNorm's running statistics updated once, not again by the
    recompute."""
    runs = []
    for ckpt in (False, True):
        torch.manual_seed(3)
        m = resnet.ResNet(**TINY, use_checkpoint=ckpt).train()
        feats = m(torch.from_numpy(_images(4, 2)))[1:]
        sum(f.square().mean() for f in feats).backward()
        runs.append((m.state_dict(), {n: p.grad for n, p in m.named_parameters()}))
    (s0, g0), (s1, g1) = runs
    assert any("running_var" in k for k in s0)
    for k in s0:
        assert torch.allclose(s0[k], s1[k], rtol=1e-6, atol=1e-7), k
    for k in g0:
        assert torch.allclose(g0[k], g1[k], rtol=1e-5, atol=1e-7), k


def test_resnet_state_dict_is_the_reference_layout():
    """JAX's ``.pth`` loader for the reference's torchvision ResNet
    (``load_torch_resnet_backbone``) reads the port's state dict key by key,
    nothing skipped, and returns the flax parameters and BatchNorm
    statistics it came from."""
    jm = jax_resnet.ResNet(**TINY)
    variables = draw_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))), 5)
    pm = resnet.ResNet(**TINY)
    sd = _port_names(variables["params"], ["encoder"], "encoder.")
    sd.update(_port_names(variables["batch_stats"], ["encoder"], "encoder.", stats=True))
    pm.load_state_dict(sd, strict=True)
    assert {"conv1.weight", "bn1.running_var", "layer1.0.downsample.0.weight",
            "layer1.0.downsample.1.bias", "layer2.0.conv2.weight"} <= set(sd)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats, loaded, skipped = load_torch_resnet_backbone(
        pm.state_dict(), zeros["params"], zeros["batch_stats"])
    assert not skipped
    assert len(loaded) == len(pm.state_dict())
    for tree, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got, want = (flax.traverse_util.flatten_dict(t) for t in (tree, want))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=str(k))


def test_published_resnet50_layout_and_size():
    """``get_backbone("resnet50")``: stages 3 / 4 / 6 / 3; the bridge of the
    flax model's full-size variables gives exactly the port's keys and
    shapes, so the parameter counts agree (23.5 M)."""
    shapes = jax.eval_shape(lambda: jax_resnet.resnet50().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k.removeprefix("encoder."): tuple(v.shape) for k, v in jax_params_to_torch(
        {"encoder": zeros["params"]}, {"encoder": zeros["batch_stats"]}).items()}
    with torch.device("meta"):
        pm = get_backbone("resnet50", image_size=512)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    assert n_flax == 23_508_032  # torchvision's 25.6 M without the classifier
    assert pm.out_channels == jax_resnet.resnet50().out_channels == (3, 256, 512, 1024, 2048)
    assert [len(getattr(pm, f"layer{i}")) for i in range(1, 5)] == [3, 4, 6, 3]


@pytest.mark.parametrize("global_batch", [96, 48])
def test_resnet_optimizer_row_matches_jax(global_batch):
    """``backbone_optim_settings("resnet50", ..., global_batch)`` equals
    JAX's: lr 1e-3 x global batch / 96, weight decay 0.05, no layer decay;
    the pretrain driver folds the same row into its config; every 1-D
    parameter (BatchNorm's) takes no weight decay, as in JAX's mask."""
    with torch.device("meta"):
        enc = get_backbone("resnet50")
    got = optim.backbone_optim_settings("resnet50", enc, global_batch)
    want = jax_optim.backbone_optim_settings("resnet50", jax_resnet.resnet50(), global_batch)
    assert got == want
    assert got["lr"] == pytest.approx(1e-3 * global_batch / 96)
    assert (got["weight_decay"], got["layer_decay"]) == (0.05, None)
    over = ["backbone=resnet50", f"data.batch_size={global_batch}"]
    jcfg = jax_apply_optim_defaults(JaxPretrainConfig().override(over), over)
    cfg = apply_optim_defaults(PretrainConfig().override(over), over)
    for k in ("lr", "weight_decay", "layer_decay"):
        assert getattr(cfg.optim, k) == getattr(jcfg.optim, k), k
    for name, p in enc.named_parameters():
        assert optim.no_weight_decay(name, p) == jax_optim.no_weight_decay(name, p), name
        assert optim.layer_decay_scale(name, got["layer_decay"], got["num_layers"]) == 1.0
