"""PyTorch port of InternImage-T SEP pretraining (samrs_tpu_torch.seg.backbones.
internimage; DCNv3 over K8; the depthwise layer ids) vs the JAX package, on
CPU in fp32.

The JAX DCNv3Module takes ``dcnv3_pallas`` only on a TPU and the gather
oracle ``sampling.dcnv3`` elsewhere; that oracle goes through [-1, 1] and
back, which can move a coordinate on an integer by an ulp to the other side
of its floor.  The port follows ``dcnv3_pallas`` (absolute coordinates, as
the JAX package runs on its accelerator), so here the JAX module's sampling
is routed through ``dcnv3_pallas(interpret=True)`` by replacing the name
``dcnv3`` in samrs_tpu.seg.backbones.internimage for the test's duration.
Tiny models: channels 16, depths (1, 1, 2, 1), groups (2, 2, 4, 4) (Gc 8 /
16 / 16 / 32), 40^2 - 64^2 images.  Variables are drawn with numpy; the
DCNv3 offset and mask linears are zero where a test says so (the JAX
initialisers: every tap on a pixel at the first step).
"""

import logging
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import samrs_tpu.seg.backbones.internimage as jax_internimage
from samrs_tpu.kernels.bilinear_gather import dcnv3_pallas
from samrs_tpu.seg.decoders.upernet import UPerHead as JaxUPerHead
from samrs_tpu.seg.frameworks import MultiHeadSegModel as JaxMultiHead
from samrs_tpu.seg.frameworks import SegHead as JaxSegHead
from samrs_tpu.seg.port import load_torch_internimage_backbone
from samrs_tpu.train import optim as jax_optim
from samrs_tpu.train.trainer import TrainState as JaxTrainState
from samrs_tpu.train.trainer import make_pretrain_step
from samrs_tpu_torch.core.config import DataConfig, OptimConfig, PretrainConfig
from samrs_tpu_torch.data.datasets import SegmentationDataset
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment
from samrs_tpu_torch.seg.backbones.internimage import InternImage, InternImageBlock
from samrs_tpu_torch.seg.decoders.upernet import UPerHead
from samrs_tpu_torch.seg.frameworks import MultiHeadSegModel, SegHead, build_multihead_model
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.seg.registry import get_backbone
from samrs_tpu_torch.train import optim
from samrs_tpu_torch.train.pretrain import run_pretrain
from samrs_tpu_torch.train.trainer import TrainState, cross_entropy_ignore, pretrain_step
from test_torch_port_seg import _rel_l2, draw_variables
from test_torch_port_train import _adam_state, _make_seg_dataset

TOL = 1e-4  # fp32 both sides; only summation order differs
TINY = dict(channels=16, depths=(1, 1, 2, 1), groups=(2, 2, 4, 4), drop_path_rate=0.0,
            layer_scale=1.0)
CLASSES = (3, 4, 5)
SIZE = 64
BATCH = (4, 3, 5)  # >= 3 a head (see test_torch_port_train.py)
LR, WARMUP, TOTAL, OFFSET = 6e-5, 2, 20, 5  # the schedule starts past its warmup: lr > 0
# JAX init: the DCNv3 sampling branch's parameters and moments after steps 1, 2, 3: TOL
# after step 1, then 3x the worst of `tests/internimage_moment_spread.py 1 8 --floor`
# (param 1.626e-3 / 1.900e-3, mu 3.118e-3 / 3.082e-3, nu 2.090e-3 / 2.569e-3 after steps
# 2 / 3, the same at 1 and 8 torch threads); every other parameter and moment at TOL
JAX_INIT_SAMPLING_TOL = {"param": {1: TOL, 2: 4.88e-3, 3: 5.70e-3},
                         "mu": {1: TOL, 2: 9.36e-3, 3: 9.25e-3},
                         "nu": {1: TOL, 2: 6.27e-3, 3: 7.71e-3}}


def _dcnv3_interpret(x, offset, mask, kernel_h, kernel_w, stride_h=1, stride_w=1, pad_h=1,
                     pad_w=1, dilation_h=1, dilation_w=1, groups=1, group_channels=16,
                     offset_scale=1.0):
    """``sampling.dcnv3``'s signature over ``dcnv3_pallas(interpret=True)``."""
    return dcnv3_pallas(x, offset, mask, kernel_h, kernel_w, stride_h, stride_w, pad_h, pad_w,
                        dilation_h, dilation_w, groups, group_channels, offset_scale,
                        interpret=True)


def _pallas_floor_coords(c):
    """Coordinates the Pallas kernel's fp32 ``t = c - x`` turns into an extra
    tap slope (``_pallas_far_lane_rounds`` in test_torch_port_seg.py: [-2^-24,
    0) and 1 - 2^-24) moved to the nearest fp32 values at which its ``_dhat``
    is the floor formula's derivative (-2^-23 and 1 - 2^-23, at most 1.2e-7 px
    away), with the gradient passed through unchanged."""
    moved = jnp.where((c < 0) & (c >= -2.0 ** -24), jnp.float32(-2.0 ** -23),
                      jnp.where(c == jnp.float32(1 - 2.0 ** -24), jnp.float32(1 - 2.0 ** -23), c))
    return c + jax.lax.stop_gradient(moved - c)


def _dcnv3_interpret_floor(x, offset, mask, kernel_h, kernel_w, stride_h=1, stride_w=1, pad_h=1,
                           pad_w=1, dilation_h=1, dilation_w=1, groups=1, group_channels=16,
                           offset_scale=1.0):
    """``dcnv3_pallas``'s own steps (samrs_tpu/kernels/bilinear_gather.py:590-633)
    with ``_pallas_floor_coords`` on the absolute coordinates before the
    interpret-mode sampler."""
    from samrs_tpu.kernels.bilinear_gather import _dcnv3_base_grid, sample_weighted

    B, H, W, _ = x.shape
    _, Ho, Wo, _ = offset.shape
    G, Gc, K = groups, group_channels, kernel_h * kernel_w
    P = Ho * Wo
    xg = x.reshape(B, H, W, G, Gc).transpose(0, 3, 1, 2, 4).reshape(B * G, H, W * Gc)
    off = offset.reshape(B, P, G, K, 2).transpose(0, 2, 1, 3, 4).reshape(B * G, P, K, 2)
    m = mask.reshape(B, P, G, K).transpose(0, 2, 1, 3).reshape(B * G, P, K)
    bx, by = _dcnv3_base_grid(Ho, Wo, kernel_h, kernel_w, stride_h, stride_w, pad_h, pad_w,
                              dilation_h, dilation_w)
    fx = _pallas_floor_coords(jnp.asarray(bx) + off[..., 0] * offset_scale)
    fy = _pallas_floor_coords(jnp.asarray(by) + off[..., 1] * offset_scale)
    out = sample_weighted(xg, fx, fy, m, Gc, True)
    return out.reshape(B, G, Ho, Wo, Gc).transpose(0, 2, 3, 1, 4).reshape(B, Ho, Wo, G * Gc)


@pytest.fixture(scope="module")
def pallas_dcnv3():
    """The JAX InternImage's DCNv3 sampling through the Pallas kernel."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_internimage, "dcnv3", _dcnv3_interpret)
        yield


@pytest.fixture(scope="module")
def pallas_dcnv3_floor():
    """The same on floor-safe coordinates (``_dcnv3_interpret_floor``): for
    the training steps, whose taps after the first update sit within ~1e-4
    px of the integers, some of them at the two points where the Pallas
    derivative is not the floor formula's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_internimage, "dcnv3", _dcnv3_interpret_floor)
        yield


def _zero_sampling(params):
    """The JAX initialisers of DCNv3's offset and mask linears: zeros."""
    flat = flax.traverse_util.flatten_dict(params)
    for k in flat:
        if "dcn" in k and k[-2] in ("offset", "mask"):
            flat[k] = np.zeros_like(flat[k])
    return flax.traverse_util.unflatten_dict(flat)


def _port_sd(params, prefix="encoder"):
    return {k.removeprefix(prefix + "."): v
            for k, v in jax_params_to_torch({prefix: params}).items()}


@pytest.mark.parametrize("zero_offsets", [False, True])
def test_block_matches_flax(pallas_dcnv3, zero_offsets):
    """One InternImage block (LN, DCNv3, layer scale, LN, MLP) on a 10x12
    map with generic offsets and with the zero initial ones (every tap on a
    pixel)."""
    jm = jax_internimage.InternImageBlock(channels=32, groups=2, layer_scale=1.0)
    x = np.random.default_rng(2).normal(size=(2, 10, 12, 32)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv = draw_variables(shapes, 3)
    if zero_offsets:
        jv = {"params": _zero_sampling(jv["params"])}
    want = jax.jit(lambda v, a: jm.apply(v, a))(jv, jnp.asarray(x))
    model = InternImageBlock(32, 2, layer_scale=1.0).eval()
    sd = {k.removeprefix("encoder.levels.0.blocks.0."): v for k, v in jax_params_to_torch(
        {"encoder": {"level0_block0": jv["params"]}}).items()}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= TOL


@pytest.fixture(scope="module")
def tiny_internimage(pallas_dcnv3):
    jm = jax_internimage.InternImage(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, SIZE, SIZE, 3))))
    jv = draw_variables(shapes, 6)
    model = InternImage(**TINY).eval()
    model.load_state_dict(_port_sd(jv["params"]), strict=True)
    return jm, jv, model


@pytest.mark.parametrize("size", [64, 40])
def test_internimage_features_match_flax(tiny_internimage, size):
    """c1..c4 of the tiny trunk (strides 4 .. 32; 40^2 pads its odd maps)."""
    jm, jv, model = tiny_internimage
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, a: jm.apply(v, a))(jv, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    assert model.out_channels == jm.out_channels == (3, 16, 32, 64, 128)
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, i
        assert _rel_l2(g, w) <= TOL, (i, _rel_l2(g, w))


def test_internimage_routes_match(tiny_internimage, monkeypatch):
    """use_kernels=False and dcn_impl="xla" run the plain versions; on the CPU
    every route is the plain version, so the three agree exactly; so does a
    row slab selected by SAMRS_BILINEAR_SLAB (3 divides no level's height
    here, 4 divides the first two)."""
    _, _, model = tiny_internimage
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 48, 48, 3)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        plain = model(x, use_kernels=False)
        xla = InternImage(**TINY, dcn_impl="xla").eval()
        xla.load_state_dict(model.state_dict())
        monkeypatch.setenv("SAMRS_BILINEAR_SLAB", "4")
        slab = model(x)
        for other in (plain, xla(x), slab):
            for a, b in zip(ref, other):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dcn_impl"):
        InternImage(**TINY, dcn_impl="cuda")


def test_internimage_bridge_round_trip(tiny_internimage):
    """Every flax leaf lands on one port key (strict load, no key twice), and
    the JAX package's reference-checkpoint loader reads the port's state dict
    (the reference key layout) back into the flax tree exactly."""
    _, jv, model = tiny_internimage
    flat = flax.traverse_util.flatten_dict(jv["params"])
    assert len(_port_sd(jv["params"])) == len(flat) == len(model.state_dict())
    params = jax.tree_util.tree_map(np.zeros_like, jv["params"])
    loaded, _, skipped = load_torch_internimage_backbone(model.state_dict(), params)
    assert skipped == []
    got = flax.traverse_util.flatten_dict(loaded)
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg="/".join(k))
    assert tuple(model.state_dict()["levels.0.blocks.0.dcn.dw_conv.0.weight"].shape) == (16, 1, 3, 3)


def test_get_backbone_builds_published_internimage_t():
    """InternImage-T at its published widths (intern_image.py / ED/models.py:89-102),
    with the JAX model's parameter count."""
    enc = get_backbone("internimage_t", image_size=512)
    assert isinstance(enc, InternImage)
    assert sum(len(lv.blocks) for lv in enc.levels) == 30
    assert enc.depths == (4, 4, 18, 4) and enc.groups == (4, 8, 16, 32)
    assert enc.out_channels == (3, 64, 128, 256, 512)
    blk = enc.levels[2].blocks[17]
    assert blk.dcn.groups == 16 and blk.gamma1 is not None and float(blk.gamma1.detach()[0]) == 1.0
    assert blk.drop_path.rate == pytest.approx(0.2 * 25 / 29)  # np.linspace(0, 0.2, 30)[25]
    assert enc.levels[3].blocks[3].drop_path.rate == pytest.approx(0.2)
    assert enc.levels[3].downsample is None and enc.levels[0].downsample.conv.bias is None
    jm = jax_internimage.internimage_t()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in enc.parameters()) == n_jax
    model = build_multihead_model("internimage_t", device="cpu", remat=True)
    assert model.encoder.use_checkpoint
    assert model.seg_decoder.channels == 128  # UperNet at out_channels[2]
    assert not model.encoder.levels[0].blocks[0].dcn.offset.weight.any()
    assert not model.encoder.levels[0].blocks[0].dcn.mask.bias.any()


def test_remat_checkpoints_blocks_with_equal_gradients(tiny_internimage):
    """use_checkpoint recomputes each block in the backward with the same
    drop-path draws: the same loss and gradients as without."""
    _, _, model = tiny_internimage
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 40, 40, 3)).astype(np.float32))
    grads = []
    for ckpt in (False, True):
        m = InternImage(**{**TINY, "drop_path_rate": 0.3}, use_checkpoint=ckpt).train()
        m.load_state_dict(model.state_dict())
        out = m(x, torch.Generator().manual_seed(5))
        sum(o.square().mean() for o in out[1:]).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-7, msg=n)


# ----------------------------------------------------------- optimizer ----


def _full_model_shapes():
    jm = JaxMultiHead(backbone="internimage_t", decoder="upernet", num_classes=(18, 20, 37),
                      image_size=64)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          [jnp.zeros((1, 64, 64, 3))] * 3, False))


def test_depthwise_layer_ids_match_jax():
    """Every parameter of the full internimage_t + UperNet model: the port's
    depthwise layer id on its name equals the JAX one on the flax path (the
    names bridged by an index tree), and so do the lr scales at rate 0.9."""
    params = _full_model_shapes()["params"]
    depths = (4, 4, 18, 4)
    flat = flax.traverse_util.flatten_dict(params)
    idx = {k: np.full(v.shape, i, np.float32) for i, (k, v) in enumerate(flat.items())}
    by_idx = {int(v.reshape(-1)[0]): n for n, v in jax_params_to_torch(
        flax.traverse_util.unflatten_dict(idx)).items()}
    model = MultiHeadSegModel("internimage_t")
    names = {n for n, _ in model.named_parameters()}
    assert set(by_idx.values()) == names
    seen = set()
    for i, k in enumerate(flat):
        path = "/".join(k)
        want = jax_optim.layer_id_for(path, 30, "depthwise", depths)
        got = optim.layer_id_for(by_idx[i], 30, "depthwise", depths)
        assert got == want, (path, by_idx[i], got, want)
        assert optim.layer_decay_scale(by_idx[i], 0.9, 30, "depthwise", depths) == \
            pytest.approx(0.9 ** (31 - want), rel=1e-12)
        seen.add(want)
    assert seen == set(range(32))  # the stem 0, blocks 1..30 (stage caps), the rest 31
    with pytest.raises(ValueError, match="depths"):
        optim.layer_id_for("encoder.levels.0.blocks.0.norm1.0.weight", 30, "depthwise")


def test_backbone_optim_settings_match_jax():
    """lr 6e-5, wd 0.05, rate 1.0, the depthwise scheme, num_layers 30 and
    depths 4/4/18/4 from the encoder, as the JAX package resolves them; the
    optimizer groups parameters by those ids."""
    enc = get_backbone("internimage_t")
    got = optim.backbone_optim_settings("internimage_t", enc)
    want = jax_optim.backbone_optim_settings("internimage_t", jax_internimage.internimage_t())
    assert got == {k: want[k] for k in ("lr", "weight_decay", "layer_decay", "scheme", "depths",
                                        "num_layers")}
    assert got["num_layers"] == 30 and got["depths"] == (4, 4, 18, 4)
    assert optim.backbone_optim_settings("vit_b_rvsa")["scheme"] == "vit"
    opt = optim.Optimizer(enc, lambda s: 1e-3, layer_decay=0.9, num_layers=30,
                          layer_id_scheme="depthwise", depths=got["depths"])
    assert len({g["lr_scale"] for g in opt.opt.param_groups}) == 31  # ids 0..30: no decoder


# ------------------------------------------------------------ training ----


class TinyJax(JaxMultiHead):
    def setup(self):
        self._block_remat = False
        self.encoder = jax_internimage.InternImage(**TINY)
        self.seg_decoder = JaxUPerHead(channels=32)
        self.heads = [JaxSegHead(nc, kernel=1, dropout=0.0, name=f"head_{i}")
                      for i, nc in enumerate(self.num_classes)]


class TinyPort(MultiHeadSegModel):
    """The port's MultiHeadSegModel with the tiny InternImage, a 32-wide
    UperNet and no dropout or drop-path (the packages' random streams
    differ)."""

    def __init__(self, num_classes=CLASSES):
        nn.Module.__init__(self)
        self.use_kernels = True
        self.backbone = "internimage_t"
        self.num_classes = tuple(num_classes)
        self.encoder = InternImage(**TINY)
        self.seg_decoder = UPerHead(self.encoder.out_channels[1:], channels=32)
        self.heads = nn.ModuleList(SegHead(32, nc, 1, dropout=0.0) for nc in self.num_classes)


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for b, nc in zip(BATCH, CLASSES):
        x = rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.integers(0, nc, (b, SIZE, SIZE)).astype(np.int32)
        y[:, :5] = 255
        out.append((x, y))
    return out


def _close(got, want, tol):
    """rel-L2 <= tol, or both zero (a parameter that no loss reaches yet: the
    DCNv3 sampling branch behind zero offset and mask linears)."""
    if not want.any():
        return not got.any()
    return _rel_l2(got, want) <= tol


def sampling_branch(name: str) -> bool:
    """The DCNv3 parameters that act only through the sampling coordinates
    and tap weights: the depthwise conv, its norm, the offset and mask
    linears."""
    return any(f".dcn.{m}." in name for m in ("dw_conv", "offset", "mask"))


@pytest.fixture(scope="module")
def jax_side(pallas_dcnv3_floor):
    return make_jax_side()


def make_jax_side():
    """The tiny flax model, its optimizer (depthwise ids at rate 0.9) and the
    jitted step, compiled once for both inits (the JAX DCNv3 must already go
    through an interpret-mode adapter)."""
    jm = TinyJax(num_classes=CLASSES, image_size=SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, SIZE, SIZE, 3))] * 3, True))
    depths = TINY["depths"]
    jsched = jax_optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    tx = jax_optim.build_optimizer(shapes["params"], lambda c: jsched(c + OFFSET),
                                   weight_decay=0.05, grad_clip=5.0, layer_decay=0.9,
                                   num_layers=sum(depths), layer_id_scheme="depthwise",
                                   depths=depths)

    return jm, shapes, tx, make_pretrain_step(jm, tx)


def run_steps(jax_side, init: str, n_steps: int = 3):
    """Three pretrain steps on both sides from the same numpy-drawn state:
    init "generic" (every leaf drawn: the taps off the integers) or "jax"
    (the DCNv3 offset and mask linears at zero, as the JAX modules initialise
    them: every tap on a pixel at the first step).  Returns the first step's
    gradients after the global-norm clip (JAX: its first Adam moment over
    1 - b1; the port: its raw gradients times min(1, 5 / norm)) and the
    snapshots after each step."""
    jm, shapes, tx, jstep = jax_side
    jv = draw_variables(shapes, 31)
    params = jv["params"] if init == "generic" else _zero_sampling(jv["params"])
    stats = jv["batch_stats"]
    depths = TINY["depths"]
    jstate = JaxTrainState.create(params, stats, tx)
    model = TinyPort()
    model.load_state_dict(jax_params_to_torch(params, stats), strict=True)
    psched = optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    opt = optim.Optimizer(model, lambda s: psched(s + OFFSET), weight_decay=0.05, grad_clip=5.0,
                          layer_decay=0.9, num_layers=sum(depths), layer_id_scheme="depthwise",
                          depths=depths)
    state = TrainState(0, model, opt)

    b0 = _batches(0)
    model.train()
    outs = model([torch.from_numpy(x) for x, _ in b0])
    sum(cross_entropy_ignore(o, torch.from_numpy(y)) for o, (_, y) in zip(outs, b0)).backward()
    pgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in pgrads.values()])))
    pgrads = {n: g * min(1.0, 5.0 / norm) for n, g in pgrads.items()}
    model.load_state_dict(jax_params_to_torch(params, stats), strict=True)  # undo BN updates
    opt.zero_grad()

    snaps = {}
    for i in range(n_steps):
        b = _batches(i)
        jstate, jm_ = jstep(jstate, tuple((jnp.asarray(x), jnp.asarray(y)) for x, y in b),
                            jax.random.PRNGKey(0))
        pm = pretrain_step(state, [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in b], 0)
        adam = _adam_state(jstate.opt_state)
        names = {p: n for n, p in model.named_parameters()}
        snaps[i + 1] = dict(
            jloss=float(jm_["loss"]), ploss=float(pm["loss"]),
            jstate=jax_params_to_torch(jstate.params, jstate.batch_stats),
            pstate={k: v.clone() for k, v in model.state_dict().items()},
            jmu=jax_params_to_torch(adam.mu), jnu=jax_params_to_torch(adam.nu),
            pmu={names[p]: s["exp_avg"].clone() for p, s in opt.opt.state.items()},
            pnu={names[p]: s["exp_avg_sq"].clone() for p, s in opt.opt.state.items()})
    jgrads = {k: v / (1.0 - 0.9) for k, v in snaps[1]["jmu"].items()}
    return jgrads, pgrads, snaps


@pytest.fixture(scope="module")
def runs(jax_side):
    return {init: run_steps(jax_side, init) for init in ("generic", "jax")}


@pytest.mark.parametrize("init", ["generic", "jax"])
def test_first_step_gradients_match_jax(runs, init):
    """Every parameter's gradient of the summed three-head loss at the first
    step (after the clip: JAX's as its step's first moment).  From the JAX init every tap lies on a pixel: the offset and mask
    linears get theirs through the one-sided coordinate derivative and the
    tap weights, and the depthwise conv and its norm none yet (zero on both
    sides)."""
    jgrads, pgrads, _ = runs[init]
    assert set(jgrads) == set(pgrads)
    for k, v in jgrads.items():
        assert _close(pgrads[k].numpy(), v.numpy(), TOL), (k, init)
    offs = [k for k in jgrads if ".dcn.offset." in k]
    assert offs and all(jgrads[k].any() for k in offs)
    if init == "jax":
        assert not any(jgrads[k].any() for k in jgrads if ".dcn.dw_conv." in k)


def _check_snapshot(snap, tol_for):
    assert abs(snap["ploss"] - snap["jloss"]) <= TOL * abs(snap["jloss"])
    assert set(snap["jstate"]) == set(snap["pstate"])
    for k, v in snap["jstate"].items():
        assert _close(snap["pstate"][k].numpy(), v.numpy(), tol_for("param", k)), k
    for moment in ("mu", "nu"):
        want, got = snap["j" + moment], snap["p" + moment]
        assert set(want) == set(got)
        for k, v in want.items():
            assert _close(got[k].numpy(), v.numpy(), tol_for(moment, k)), (moment, k)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_pretrain_steps_match_make_pretrain_step(runs, n_steps):
    """Generic init: loss, parameters, BatchNorm running statistics and both
    AdamW moments after one and after three steps, all at TOL."""
    _check_snapshot(runs["generic"][2][n_steps], lambda what, k: TOL)


@pytest.mark.parametrize("n_steps", [1, 2, 3])
def test_pretrain_steps_from_jax_init_match(runs, n_steps):
    """The JAX init (every tap on a pixel at step 1): the loss, and every
    parameter and moment outside the DCNv3 sampling branch at TOL after
    each step.  The sampling branch's parameters start at zero, so after a
    step they are the Adam update itself, and from step 2 on the taps sit
    within an update of the integers, where the one-sided derivative jumps
    by a whole pixel difference at each crossing, and the two packages'
    offsets (1e-4 apart after Adam's first, normalised update) put a few taps
    on opposite sides: there they are held at JAX_INIT_SAMPLING_TOL (3x the
    worst of the measured spread, tests/internimage_moment_spread.py)."""
    tol = lambda what, k: JAX_INIT_SAMPLING_TOL[what][n_steps] if sampling_branch(k) else TOL
    _check_snapshot(runs["jax"][2][n_steps], tol)


def test_run_pretrain_internimage_end_to_end(tmp_path, caplog):
    """``run_pretrain`` with backbone=internimage_t (the family's depthwise
    layer ids from the encoder's depths) on two tmp datasets with the tiny
    model: 2 iterations, an eval, checkpoints."""
    size = 32
    roots = {n: _make_seg_dataset(tmp_path, n, size) for n in ("sota", "sior")}
    ds = lambda split, aug: {n: SegmentationDataset(str(r), str(r / "images"), str(r / "labels"),
                                                    split=split, transform=aug, val_images=8)
                             for n, r in roots.items()}
    cfg = PretrainConfig(backbone="internimage_t", total_iters=2, eval_interval=2, seed=0,
                         device="cpu",
                         data=DataConfig(root=str(tmp_path), datasets=("sota", "sior"),
                                         image_size=size, batch_size=16, num_workers=2,
                                         val_images=8),
                         optim=OptimConfig(lr=1e-3, warmup_iters=1, layer_decay=0.9),
                         ckpt_dir=str(tmp_path / "ckpt"))
    model = TinyPort((18, 20))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.INFO, logger="samrs_tpu_torch.pretrain"):
        state = run_pretrain(cfg, model=model,
                             datasets_trn=ds("trn", TrainAugment(size, rng=np.random.default_rng(0))),
                             datasets_val=ds("val", EvalAugment(size)))
    assert state.step == 2
    scales = {g["lr_scale"] for g in state.optimizer.opt.param_groups}
    assert len(scales) > 2  # depthwise ids over sum(TINY depths) = 5 layers
    for f in ("last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"):
        assert os.path.exists(tmp_path / "ckpt" / f), f
    vals = [r.getMessage() for r in caplog.records if r.getMessage().startswith("val[")]
    assert {v.split("]")[0] for v in vals} == {"val[sota", "val[sior"}
    moved = model.state_dict()["encoder.levels.0.blocks.0.dcn.offset.weight"]
    assert not torch.equal(moved, before["encoder.levels.0.blocks.0.dcn.offset.weight"])
