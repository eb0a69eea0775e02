"""ViTAEv2-S in the PyTorch port (samrs_tpu_torch.seg.backbones.vitae) vs the
JAX package, on CPU in fp32.

A tiny ViTAEv2 (tokens 16 / 16 / 32 / 32, one NormalCell a stage, the
published kernels, dilations, strides and token types: windowed stages 0 /
1, 'transformer' stages 2 / 3) runs on flax variables whose every leaf is
drawn with numpy (draw_variables), bridged with ``jax_params_to_torch`` and
loaded strictly: c1..c4, the gradients of a fixed random projection of them
with respect to every parameter, and the PCM BatchNorms' statistics
(``_parity``, TOL 1e-4), in train and eval mode.  At 64^2 the windowed
stages pad (16^2 -> 21^2, 8^2 -> 14^2).  The bias of a PCM's first and
second conv feeds a BatchNorm, which in train mode removes it: no true
gradient there, so both sides return rounding noise, held to 1e-6 of the
gradient's norm.
Also: the drop-path slices, JAX's ``.pth`` loader reads the port's state
dict (the reference key layout), the published model's parameters,
per-cell checkpointing with the statistics updated once, the optimizer row.
The whole SEP step is in test_torch_port_sep_backbones.py.
"""

import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.seg.backbones import vitae as jax_vitae
from samrs_tpu.seg.port import load_torch_vitae_backbone
from samrs_tpu.train import optim as jax_optim
from samrs_tpu_torch.seg.backbones import vitae
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.seg.registry import get_backbone
from samrs_tpu_torch.train import optim
from test_torch_port_resnet import two_torch_threads  # noqa: F401 (autouse)
from test_torch_port_seg import draw_variables
from test_torch_port_vit_adapter import _assert_parity, _nchw, _parity, _port_names

SIZE = 64
TINY = dict(embed_dims=(8, 8, 16, 16), token_dims=(16, 16, 32, 32), NC_depth=(1, 1, 1, 1),
            NC_heads=(1, 2, 2, 4), RC_heads=(1, 1, 2, 2), NC_group=(1, 4, 8, 8),
            RC_group=(1, 4, 8, 8), drop_path_rate=0.0)
N_STATS = 32  # 2 BatchNorms in each of 8 PCMs, mean and variance


def _images(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def pcm_shift_biases(model):
    """The biases of each PCM's first and second conv (a BatchNorm follows)."""
    return tuple(n for n, _ in model.named_parameters() if re.search(r"PCM\.[03]\.bias$", n))


@pytest.mark.parametrize("train", [True, False])
def test_vitae_matches_flax(train):
    """c1..c4 (16^2 .. 2^2), every gradient (the PRM's dilated convs, the
    PCMs' grouped convs, the windowed and the V-skip attention, the MLPs)
    and the PCM BatchNorms' statistics: in train mode the batch statistics
    and the running averages, in eval mode the running statistics."""
    x = _images(1)
    pm = vitae.ViTAEv2(**TINY)
    shifts = pcm_shift_biases(pm) if train else ()  # the running statistics keep the shift
    res = _parity(jax_vitae.ViTAEv2(**TINY), (jnp.asarray(x), train), pm,
                  lambda m, _: m(torch.from_numpy(x))[1:], ["encoder"], "encoder.", 2,
                  jout=lambda outs: _nchw(outs[1:]), train=train, no_grad=shifts)
    assert len(res["grad"]) + len(shifts) == 198
    _assert_parity(res, n_stats=N_STATS)
    assert set(res["noise"]) == set(shifts)
    if train:
        assert len(shifts) == 16
        assert max(res["noise"].values()) <= 1e-6, res["noise"]


def test_drop_path_slices_match_jax():
    """The NormalCells' drop-path rates of the published model equal JAX's
    ``_nc_dpr`` (stage s starts at NC_depth[s - 1] of linspace(0, 0.3, 14));
    the ReductionCells have none."""
    with torch.device("meta"):
        pm = get_backbone("vitaev2_s")
    got = [[c.drop_path.rate for c in layer.NC] for layer in pm.layers]
    want = jax_vitae.vitaev2_s()._nc_dpr()
    assert [len(g) for g in got] == [len(w) for w in want] == [2, 2, 8, 2]
    for g, w in zip(got, want):
        assert g == pytest.approx(w)
    assert got[2][0] == got[1][0] == pytest.approx(0.3 * 2 / 13)  # stage 2 restarts at dpr[2]
    assert not any("drop_path" in n for n, _ in pm.layers[0].RC.named_modules())


def test_vitae_per_cell_checkpointing():
    """``use_checkpoint`` recomputes each cell in the backward: the same
    features and gradients (drop path on), every PCM BatchNorm's running
    statistics updated once."""
    cfg = dict(TINY, drop_path_rate=0.3)
    runs = []
    for ckpt in (False, True):
        torch.manual_seed(3)
        m = vitae.ViTAEv2(**cfg, use_checkpoint=ckpt).train()
        feats = m(torch.from_numpy(_images(4, 2)), torch.Generator().manual_seed(5))[1:]
        sum(f.square().mean() for f in feats).backward()
        runs.append((m.state_dict(),
                     [f.detach() for f in feats] + [p.grad for p in m.parameters()]))
    (s0, g0), (s1, g1) = runs
    assert sum("running_var" in k for k in s0) == N_STATS // 2
    for k in s0:
        assert torch.allclose(s0[k], s1[k], rtol=1e-6, atol=1e-7), k
    for a, b in zip(g0, g1):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


def test_vitae_state_dict_is_the_reference_layout():
    """JAX's ``.pth`` loader for the reference ViTAEv2 (``load_torch_vitae_
    backbone``) reads the port's state dict key by key, nothing skipped, and
    returns the flax parameters and BatchNorm statistics it came from."""
    jm = jax_vitae.ViTAEv2(**TINY)
    variables = draw_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))), 7)
    pm = vitae.ViTAEv2(**TINY)
    sd = _port_names(variables["params"], ["encoder"], "encoder.")
    sd.update(_port_names(variables["batch_stats"], ["encoder"], "encoder.", stats=True))
    pm.load_state_dict(sd, strict=True)
    assert {"layers.0.RC.PRM.convs.3.0.weight", "layers.0.RC.PCM.6.weight",
            "layers.1.RC.PCM.4.running_var", "layers.0.RC.attn.attn.qkv.weight",
            "layers.2.RC.attn.attn.proj.bias", "layers.3.RC.attn.mlp.fc2.weight",
            "layers.0.NC.0.attn.qkv.weight", "layers.3.NC.0.PCM.3.weight"} <= set(sd)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats, loaded, skipped = load_torch_vitae_backbone(
        pm.state_dict(), zeros["params"], zeros["batch_stats"])
    assert not skipped
    assert len(loaded) == len(pm.state_dict())
    for tree, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got, want = (flax.traverse_util.flatten_dict(t) for t in (tree, want))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=str(k))


def test_published_vitaev2_s_layout_and_size():
    """``get_backbone("vitaev2_s")``: ViTAEv2's defaults (tokens 64 / 128 /
    256 / 512, NormalCells 2 / 2 / 8 / 2); the bridge of the flax model's
    full-size variables gives exactly the port's keys and shapes, so the
    parameter counts agree (18.9 M)."""
    shapes = jax.eval_shape(lambda: jax_vitae.vitaev2_s().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k.removeprefix("encoder."): tuple(v.shape) for k, v in jax_params_to_torch(
        {"encoder": zeros["params"]}, {"encoder": zeros["batch_stats"]}).items()}
    with torch.device("meta"):
        pm = get_backbone("vitaev2_s", image_size=512)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    assert 18.8e6 < n_flax < 19.0e6
    assert pm.out_channels == jax_vitae.vitaev2_s().out_channels == (3, 64, 128, 256, 512)
    assert [len(layer.NC) for layer in pm.layers] == [2, 2, 8, 2]


def test_vitae_optimizer_row_matches_jax():
    """``backbone_optim_settings("vitaev2_s")`` equals JAX's (lr 6e-5, weight
    decay 0.01, no layer decay); every parameter's decay flag equals JAX's
    mask on the flax names."""
    with torch.device("meta"):
        enc = get_backbone("vitaev2_s")
    got = optim.backbone_optim_settings("vitaev2_s", enc)
    assert got == jax_optim.backbone_optim_settings("vitaev2_s", jax_vitae.vitaev2_s())
    assert (got["lr"], got["weight_decay"], got["layer_decay"]) == (6e-5, 0.01, None)
    params = jax.eval_shape(lambda: jax_vitae.ViTAEv2(**TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))["params"]
    decay = jax.tree_util.tree_map_with_path(lambda p, v: np.full(v.shape, float(
        not jax_optim.no_weight_decay(jax_optim._path_str(p), v)), np.float32), params)
    want = {k.removeprefix("encoder."): bool(v.reshape(-1)[0])
            for k, v in jax_params_to_torch({"encoder": decay}).items()}
    pm = vitae.ViTAEv2(**TINY)
    assert {n: not optim.no_weight_decay(n, p) for n, p in pm.named_parameters()} == want
