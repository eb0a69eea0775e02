"""Swin-T in the PyTorch port (samrs_tpu_torch.seg.backbones.swin) vs the JAX
package, on CPU in fp32.

A tiny Swin (embed 16, depths 2 / 2 / 2 / 2, heads 1 / 2 / 2 / 4, window 7)
runs on flax variables whose every leaf is drawn with numpy (draw_variables:
the bias tables too), bridged with ``jax_params_to_torch`` and loaded
strictly: c1..c4, the gradients of a fixed random projection of them with
respect to every parameter (``_parity``, TOL 1e-4).  At 64^2 every stage
pads (16^2 -> 21^2, 8^2 -> 14^2, 4^2 and 2^2 -> 7^2) and every second block
rolls the padded map, as the reference does; at 56^2 the first two stages
do not pad.  Also: K11 at Swin-T's widths (C 96 / 192 / 384 / 768, M 4C)
against JAX ``fused_mlp`` in interpret mode; the shift mask and the relative
position index against the JAX module's; JAX's ``.pth`` loader reads the
port's state dict (the reference key layout); the published model's
parameters; per-block checkpointing; the optimizer row.  The whole SEP step
is in test_torch_port_sep_backbones.py.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.kernels.fused_mlp import fused_mlp as jax_fused_mlp
from samrs_tpu.seg.backbones import swin as jax_swin
from samrs_tpu.seg.port import load_torch_swin_backbone
from samrs_tpu.train import optim as jax_optim
from samrs_tpu_torch.kernels import fused_mlp
from samrs_tpu_torch.seg.backbones import swin
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.seg.registry import get_backbone
from samrs_tpu_torch.train import optim
from test_torch_port_seg import _k11_inputs, _rel_l2, _vjp_jax, _vjp_port, draw_variables
from test_torch_port_resnet import two_torch_threads  # noqa: F401 (autouse)
from test_torch_port_vit_adapter import _assert_parity, _nchw, _parity, _port_names

TINY = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), drop_path_rate=0.0)


def _images(seed, size, n=3):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size,train", [(64, True), (64, False), (56, True)])
def test_swin_matches_flax(size, train):
    """c1..c4 and every gradient (the bias tables' through their gather) of
    the tiny Swin, in train and eval mode (no BatchNorm: the same function;
    drop path off); at 64^2 every stage pads and shifts the padded map."""
    x = _images(1, size)
    res = _parity(jax_swin.Swin(**TINY), (jnp.asarray(x), train), swin.Swin(**TINY),
                  lambda m, _: m(torch.from_numpy(x))[1:], ["encoder"], "encoder.", 2,
                  jout=lambda outs: _nchw(outs[1:]), train=train)
    assert len(res["out"]) == 4 and len(res["grad"]) == 125
    assert "layers.3.blocks.1.attn.relative_position_bias_table" in res["grad"]
    _assert_parity(res)


@pytest.mark.parametrize("Hp,ws", [(21, 7), (7, 7), (56, 7), (14, 7)])
def test_shift_mask_and_rel_index_match_jax(Hp, ws):
    """The -100 mask of the rolled regions (on the padded grid) and the bias
    table's index equal the JAX module's."""
    np.testing.assert_array_equal(swin.shift_attn_mask(Hp, Hp, ws, ws // 2, "cpu").numpy(),
                                  jax_swin._shift_attn_mask(Hp, Hp, ws, ws // 2))
    np.testing.assert_array_equal(swin._rel_index(ws), jax_swin._rel_index(ws))
    blk = swin.SwinBlock(16, 2, ws, ws // 2)
    assert "attn.relative_position_index" not in blk.state_dict()  # not persistent


@pytest.mark.parametrize("C", [96, 192, 384, 768])
def test_k11_plain_matches_jax_at_swin_widths(C):
    """K11 at Swin-T's four MLP widths (M = 4C), 37 tokens: the port's
    ``fused_mlp`` (its plain version on the CPU) against JAX ``fused_mlp(
    dtype=float32)`` with the Pallas kernel in interpret mode, forward and
    VJP at K11's 2e-6; C 96 takes the fused form on the card, C 192 .. 768
    the two launches."""
    (x, w1, b1, w2, b2), dout = _k11_inputs((37,), C, 4 * C, C)

    def jax_fn(x, w1, b1, w2, b2):
        return jax_fused_mlp(x, w1.T, b1, w2.T, b2, dtype=jnp.float32, interpret=True)

    want = _vjp_jax(jax_fn, (x, w1, b1, w2, b2), dout)
    got = _vjp_port(fused_mlp.fused_mlp, (x, w1, b1, w2, b2), dout)
    for name, g, w in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert _rel_l2(g, w) <= 2e-6, (name, _rel_l2(g, w))
    assert fused_mlp.hidden_on_chip(C) == (C == 96)


def test_swin_per_block_checkpointing():
    """``use_checkpoint`` recomputes each block in the backward: the same
    features and gradients, drop path on (its masks drawn again from the
    generator's saved state)."""
    cfg = dict(TINY, drop_path_rate=0.3)
    runs = []
    for ckpt in (False, True):
        torch.manual_seed(3)
        m = swin.Swin(**cfg, use_checkpoint=ckpt).train()
        feats = m(torch.from_numpy(_images(4, 64, 2)), torch.Generator().manual_seed(5))[1:]
        sum(f.square().mean() for f in feats).backward()
        runs.append([f.detach() for f in feats] + [p.grad for p in m.parameters()])
    for a, b in zip(*runs):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


def test_swin_state_dict_is_the_reference_layout():
    """JAX's ``.pth`` loader for the reference Swin (``load_torch_swin_
    backbone``) reads the port's state dict key by key, nothing skipped, and
    returns the flax parameters it came from."""
    jm = jax_swin.Swin(**TINY)
    params = draw_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"], 6)
    pm = swin.Swin(**TINY)
    sd = _port_names(params, ["encoder"], "encoder.")
    pm.load_state_dict(sd, strict=True)
    assert {"patch_embed.proj.weight", "patch_embed.norm.bias", "layers.1.downsample.reduction"
            ".weight", "layers.0.blocks.1.attn.relative_position_bias_table", "norm3.weight",
            "layers.2.blocks.0.mlp.fc2.bias"} <= set(sd)
    new, loaded, skipped = load_torch_swin_backbone(
        pm.state_dict(), jax.tree_util.tree_map(np.zeros_like, params))
    assert not skipped
    assert len(loaded) == len(pm.state_dict())
    got, want = (flax.traverse_util.flatten_dict(t) for t in (new, params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=str(k))


def test_published_swin_t_layout_and_size():
    """``get_backbone("swin_t")``: embed 96, depths 2 / 2 / 6 / 2, heads 3 /
    6 / 12 / 24, window 7, drop path 0.3; the bridge of the flax model's
    full-size variables gives exactly the port's keys and shapes, so the
    parameter counts agree (27.5 M)."""
    shapes = jax.eval_shape(lambda: jax_swin.swin_t().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k.removeprefix("encoder."): tuple(v.shape)
            for k, v in jax_params_to_torch({"encoder": zeros["params"]}).items()}
    with torch.device("meta"):
        pm = get_backbone("swin_t", image_size=512)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    assert 27.4e6 < n_flax < 27.6e6
    assert pm.out_channels == jax_swin.swin_t().out_channels == (3, 96, 192, 384, 768)
    blocks = [b for layer in pm.layers for b in layer.blocks]
    assert [b.shift for b in blocks] == [0, 3] * 6
    assert [b.drop_path.rate for b in blocks] == pytest.approx(np.linspace(0, 0.3, 12))


def test_swin_optimizer_row_matches_jax():
    """``backbone_optim_settings("swin_t")`` equals JAX's (lr 6e-5, weight
    decay 0.01, no layer decay); every parameter's decay flag equals JAX's
    mask on the flax names: the bias tables, the norms and the biases take
    none."""
    with torch.device("meta"):
        enc = get_backbone("swin_t")
    got = optim.backbone_optim_settings("swin_t", enc)
    assert got == jax_optim.backbone_optim_settings("swin_t", jax_swin.swin_t())
    assert (got["lr"], got["weight_decay"], got["layer_decay"]) == (6e-5, 0.01, None)
    params = jax.eval_shape(lambda: jax_swin.Swin(**TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    decay = jax.tree_util.tree_map_with_path(lambda p, v: np.full(v.shape, float(
        not jax_optim.no_weight_decay(jax_optim._path_str(p), v)), np.float32), params)
    want = {k.removeprefix("encoder."): bool(v.reshape(-1)[0])
            for k, v in jax_params_to_torch({"encoder": decay}).items()}
    pm = swin.Swin(**TINY)
    assert {n: not optim.no_weight_decay(n, p) for n, p in pm.named_parameters()} == want
    assert not want["layers.0.blocks.0.attn.relative_position_bias_table"]
