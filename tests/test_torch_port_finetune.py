"""PyTorch port of finetuning and sliding-window testing (vit_b, SegModel,
samrs_tpu_torch.train.finetune / evaluate) vs the JAX package, on CPU in fp32.

Models are small (depth 2, width 32-64, 2 heads, 32-96 px images) and their
flax variables are drawn with numpy (``draw_variables``), bridged with
``jax_params_to_torch`` and loaded strictly.  Each test states its tolerance.
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
from PIL import Image
from torch import nn

from samrs_tpu.data.datasets import ISAIDDataset as JaxISAID
from samrs_tpu.data.datasets import ISPRSDataset as JaxISPRS
from samrs_tpu.data.datasets import isprs_rgb_to_label as jax_isprs_rgb_to_label
from samrs_tpu.data.transforms import EvalAugment as JaxEvalAugment
from samrs_tpu.nn import layers as jax_layers
from samrs_tpu.seg.backbones.vit import ViTSeg as JaxViTSeg
from samrs_tpu.seg.decoders.upernet import UPerHead as JaxUPerHead
from samrs_tpu.seg.frameworks import SegHead as JaxSegHead
from samrs_tpu.seg.frameworks import SegModel as JaxSegModel
from samrs_tpu.seg.port import load_torch_vitseg_backbone
from samrs_tpu.train import evaluate as jax_evaluate
from samrs_tpu.train import optim as jax_optim
from samrs_tpu.train.finetune import _interp_pos_embed_tree
from samrs_tpu.train.trainer import TrainState as JaxTrainState
from samrs_tpu.train.trainer import make_finetune_step
from samrs_tpu_torch.core.config import DataConfig, FinetuneConfig, OptimConfig, PretrainConfig
from samrs_tpu_torch.data.datasets import (ISPRS_PALETTE, ISAIDDataset, ISPRSDataset,
                                           SegmentationDataset, isprs_rgb_to_label)
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment
from samrs_tpu_torch.seg.backbones.rvsa import ViTRVSA
from samrs_tpu_torch.seg.backbones.vit import ViTSeg, jax_bicubic_weights
from samrs_tpu_torch.seg.decoders.upernet import UPerHead
from samrs_tpu_torch.seg.frameworks import SegHead, SegModel, build_seg_model
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.train import evaluate, optim
from samrs_tpu_torch.train.finetune import (interp_pos_embed, load_pretrained_encoder,
                                            run_finetune)
from samrs_tpu_torch.train.pretrain import run_pretrain
from samrs_tpu_torch.train.trainer import TrainState, finetune_step
from test_torch_port_seg import TINY_RVSA, _rel_l2, draw_variables
from test_torch_port_train import TinyPort, _adam_state, _to_flax

TOL = 1e-4  # whole models in fp32 on both sides; only summation order differs
TINY_VIT = dict(embed_dim=64, depth=2, num_heads=2, drop_path_rate=0.0)
SIZE = 64  # 4x4 tokens


def _jax_apply(module, variables, *args, **kw):
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


# ------------------------------------------------------------ ViTSeg ----


@pytest.fixture(scope="module")
def tiny_vit():
    """(flax ViTSeg, variables, port ViTSeg) of width 64, depth 2, at 64^2;
    every leaf drawn (pos_embed too)."""
    jm = JaxViTSeg(img_size=SIZE, **TINY_VIT)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    jvars = draw_variables(shapes, 41)
    model = ViTSeg(img_size=SIZE, **TINY_VIT).eval()
    sd = {k.removeprefix("encoder."): v
          for k, v in jax_params_to_torch({"encoder": jvars["params"]}).items()}
    model.load_state_dict(sd, strict=True)
    return jm, jvars, model


@pytest.mark.parametrize("size", [SIZE, 96, 48])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_vitseg_matches_jax(tiny_vit, size, impl):
    """The trunk, final norm and neck at 64^2 (the pos-embed's grid), 96^2
    (upscaled) and 48^2 (downscaled with jax.image's antialiased bicubic);
    flax with its defaults ("xla") against the port's plain routing, flax
    with "flash" / "fused" against the port's K10 / K11 routing (their plain
    versions here).  fp32 at 1e-4."""
    jm, jvars, model = tiny_vit
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    try:
        if impl == "flash":
            jax_layers.set_default_attn_impl("flash")
            jax_layers.set_default_mlp_impl("fused")
        want = _jax_apply(jm, jvars, jnp.asarray(x))
    finally:
        jax_layers.set_default_attn_impl("xla")
        jax_layers.set_default_mlp_impl("xla")
    with torch.no_grad():
        got = model(torch.from_numpy(x), use_kernels=impl == "flash")
    assert len(got) == 5
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, i
        assert _rel_l2(g, w) <= TOL, (i, _rel_l2(g, w))


@pytest.mark.parametrize("n_in,n_out", [(4, 6), (6, 4), (32, 56), (5, 5)])
def test_jax_bicubic_weights_match_jax_image_resize(n_in, n_out):
    """The port's copy of jax.image's bicubic weights (Keys a = -0.5,
    antialiased downscale) reproduces jax.image.resize on a random map, 1e-6."""
    x = np.random.default_rng(n_in * n_out).normal(size=(1, n_in, n_in, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, n_out, n_out, 3), "bicubic"))
    w = jax_bicubic_weights(n_in, n_out)
    got = np.einsum("bhwc,hy,wx->byxc", x, w, w)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_vitseg_bridge_round_trip(tiny_vit):
    """The JAX package's reference-checkpoint loader reads the port's ViTSeg
    state dict back into the flax tree exactly."""
    _, jvars, model = tiny_vit
    params = jax.tree_util.tree_map(np.zeros_like, jvars["params"])
    loaded, _, skipped = load_torch_vitseg_backbone(model.state_dict(), params)
    assert skipped == []
    flat_want = flax.traverse_util.flatten_dict(jvars["params"])
    flat_got = flax.traverse_util.flatten_dict(loaded)
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), v, err_msg="/".join(k))


def test_build_seg_model_registers_vit_b():
    model = build_seg_model("vit_b", num_classes=4, image_size=32, device="cpu")
    assert isinstance(model.encoder, ViTSeg) and model.encoder.depth == 12
    assert model.encoder.embed_dim == 768 and model.head.conv.out_channels == 4
    assert model.encoder.pos_embed.std() > 0  # normal(0.02), as flax initialises it
    assert optim.backbone_optim_settings("vit_b", model.encoder)["num_layers"] == 12


# ------------------------------------------------- SegModel + step ----

STEP_SIZE, CLASSES, BATCH = 80, 5, 4  # 5x5 tokens; >= 3 images (the 1x1 PPM BatchNorm)
LR, WARMUP, TOTAL, OFFSET = 6e-5, 2, 20, 5
STEP_VIT = dict(embed_dim=32, depth=2, num_heads=2, drop_path_rate=0.0)
# no true gradient: the neck's last deconv biases (the next BatchNorm removes a
# per-channel shift) and the full-attention key biases (softmax is blind to q.b_k)
ZERO_GRAD = {"encoder.fpn1.3.bias": slice(None), "encoder.fpn2.0.bias": slice(None),
             **{f"encoder.blocks.{i}.attn.qkv.bias": slice(32, 64) for i in range(2)}}


class TinyJaxSeg(JaxSegModel):
    def setup(self):
        self.encoder = JaxViTSeg(img_size=STEP_SIZE, **STEP_VIT)
        self.seg_decoder = JaxUPerHead(channels=16)
        self.head = JaxSegHead(self.num_classes, kernel=1, dropout=0.0)


class TinyPortSeg(SegModel):
    """The port's SegModel with a width-32 ViT (or RVSA) trunk, a 16-wide
    UperNet and no dropout or drop-path (the two packages' streams differ)."""

    def __init__(self, num_classes=CLASSES, size=STEP_SIZE, rvsa=False):
        nn.Module.__init__(self)
        self.use_kernels = True
        self.num_classes = num_classes
        self.encoder = (ViTRVSA(img_size=size, **TINY_RVSA) if rvsa
                        else ViTSeg(img_size=size, **STEP_VIT))
        self.seg_decoder = UPerHead(self.encoder.out_channels[1:], channels=16)
        self.head = SegHead(16, num_classes, 1, dropout=0.0)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BATCH, STEP_SIZE, STEP_SIZE, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, (BATCH, STEP_SIZE, STEP_SIZE)).astype(np.int32)
    y[:, :6] = 255
    return x, y


@pytest.fixture(scope="module")
def finetune_run():
    """Three finetune steps on both sides from the same numpy-drawn state,
    with the ZERO_GRAD coordinates held to zero on both; snapshots after
    steps 1 and 3, and the first step's raw gradients."""
    jm = TinyJaxSeg(num_classes=CLASSES, image_size=STEP_SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, STEP_SIZE, STEP_SIZE, 3)), True))
    jvars = draw_variables(shapes, 51)
    params, stats = jvars["params"], jvars["batch_stats"]
    model = TinyPortSeg()
    model.load_state_dict(jax_params_to_torch(params, stats), strict=True)
    keep = {}
    for n, p in model.named_parameters():
        m = np.ones(tuple(p.shape), np.float32)
        if n in ZERO_GRAD:
            m[ZERO_GRAD[n]] = 0.0
            p.register_hook(lambda g, m=torch.from_numpy(m): g * m)
        keep[n] = m
    flat = flax.traverse_util.flatten_dict(params)
    idx_tree = flax.traverse_util.unflatten_dict(
        {k: np.full(np.shape(v), i, np.float32) for i, (k, v) in enumerate(flat.items())})
    by_idx = {int(v.reshape(-1)[0]): n for n, v in jax_params_to_torch(idx_tree).items()}
    jkeep = flax.traverse_util.unflatten_dict(
        {k: _to_flax(keep[by_idx[i]], v.shape) for i, (k, v) in enumerate(flat.items())})
    jsched = jax_optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    tx = jax_optim.build_optimizer(params, lambda c: jsched(c + OFFSET), weight_decay=0.05,
                                   grad_clip=5.0, layer_decay=0.9, num_layers=2)
    tx = optax.chain(optax.stateless(lambda u, _: jax.tree_util.tree_map(
        lambda a, m: a * m, u, jkeep)), tx)
    jstate = JaxTrainState.create(params, stats, tx)
    jstep = make_finetune_step(jm, tx)
    psched = optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    opt = optim.Optimizer(model, lambda s: psched(s + OFFSET), weight_decay=0.05, grad_clip=5.0,
                          layer_decay=0.9, num_layers=2)
    state = TrainState(0, model, opt)

    x0, y0 = _batch(0)

    def loss_fn(p):
        from samrs_tpu.train.trainer import cross_entropy_ignore as jax_ce

        out, _ = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x0), True,
                          mutable=["batch_stats"])
        return jax_ce(out, jnp.asarray(y0))

    jgrads = jax.jit(jax.grad(loss_fn))(params)
    model.train()
    from samrs_tpu_torch.train.trainer import cross_entropy_ignore

    cross_entropy_ignore(model(torch.from_numpy(x0)), torch.from_numpy(y0)).backward()
    pgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.load_state_dict(jax_params_to_torch(params, stats), strict=True)  # undo BN updates
    opt.zero_grad()

    snaps = {}
    for i in range(3):
        x, y = _batch(i)
        jstate, jm_ = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        pm = finetune_step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
        if i in (0, 2):
            adam = _adam_state(jstate.opt_state)
            names = {p: n for n, p in model.named_parameters()}
            snaps[i + 1] = dict(
                jloss=float(jm_["loss"]), ploss=float(pm["loss"]),
                jstate=jax_params_to_torch(jstate.params, jstate.batch_stats),
                pstate={k: v.clone() for k, v in model.state_dict().items()},
                jmu=jax_params_to_torch(adam.mu), jnu=jax_params_to_torch(adam.nu),
                pmu={names[p]: s["exp_avg"].clone() for p, s in opt.opt.state.items()},
                pnu={names[p]: s["exp_avg_sq"].clone() for p, s in opt.opt.state.items()})
    return jax_params_to_torch(jgrads), pgrads, snaps


def test_segmodel_first_gradients_match_jax(finetune_run):
    """Every parameter's gradient of the finetune loss (SegModel: ViTSeg,
    UperNet, one head) against jax.grad of the flax SegModel, 1e-4 rel-L2;
    the zero-gradient coordinates are noise in JAX and held to zero here."""
    jgrads, pgrads, _ = finetune_run
    assert set(jgrads) == set(pgrads)
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jgrads.values()))
    for k, v in jgrads.items():
        g, w = pgrads[k].numpy().copy(), v.numpy().copy()
        if k in ZERO_GRAD:
            assert np.abs(w[ZERO_GRAD[k]]).max() <= 1e-6 * total, k
            assert not g[ZERO_GRAD[k]].any(), k
            g[ZERO_GRAD[k]] = w[ZERO_GRAD[k]] = 0.0
            if not w.any():
                continue
        assert _rel_l2(g, w) <= TOL, (k, _rel_l2(g, w))


# After three steps the Adam moments of a few tensors (the neck's x4 branch and
# the BatchNorm after it) part at ~3e-3 while the parameters still agree to
# ~4e-6: where a moment nearly cancels, Adam's normalised update turns the first
# gradient's fp32 rounding (1.6e-5) into a step that the BatchNorms amplify in
# the next gradient.  A bug gives O(1) there; the parameters keep 1e-4.
MOMENT_TOL_3 = 1e-2


@pytest.mark.parametrize("n_steps", [1, 3])
def test_finetune_steps_match_make_finetune_step(finetune_run, n_steps):
    """Loss, parameters and BatchNorm running statistics after one and three
    finetune steps at 1e-4 rel-L2; both Adam moments at 1e-4 after one step
    and MOMENT_TOL_3 after three."""
    snap = finetune_run[2][n_steps]
    moment_tol = TOL if n_steps == 1 else MOMENT_TOL_3
    assert abs(snap["ploss"] - snap["jloss"]) <= TOL * abs(snap["jloss"])
    assert set(snap["jstate"]) == set(snap["pstate"])
    for k, v in snap["jstate"].items():
        assert _rel_l2(snap["pstate"][k].numpy(), v.numpy()) <= TOL, k
    for moment in ("mu", "nu"):
        want, got = snap["j" + moment], snap["p" + moment]
        assert set(want) == set(got)
        for k, v in want.items():
            if not v.any():
                assert not got[k].any(), (moment, k)
                continue
            assert _rel_l2(got[k].numpy(), v.numpy()) <= moment_tol, (moment, k)


# ------------------------------------------------------------- data ----


def _write_isprs(root, names, hw, rng, off_palette=True):
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for nm in names:
        rgb = ISPRS_PALETTE[rng.integers(0, 6, hw)]
        if off_palette:
            rgb[hw[0] // 2, hw[1] // 2:] = (7, 8, 9)  # no class: ignored
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            root / "images" / f"{nm}.png")
        Image.fromarray(rgb).save(root / "labels" / f"{nm}.png")


def _split_files(root, names, n_train):
    (root / "train.txt").write_text("\n".join(names[:n_train]))
    (root / "valid.txt").write_text("\n".join(names[n_train:]))


def test_isprs_rgb_to_label_matches_jax():
    rng = np.random.default_rng(2)
    rgb = ISPRS_PALETTE[rng.integers(0, 6, (9, 11))]
    rgb[3, 4] = (1, 2, 3)
    got = isprs_rgb_to_label(rgb)
    np.testing.assert_array_equal(got, jax_isprs_rgb_to_label(rgb))
    assert got[3, 4] == 255 and got.dtype == np.uint8


@pytest.mark.parametrize("kind", ["isprs", "isaid_rgb", "isaid_gray"])
def test_finetune_dataset_items_match_jax(tmp_path, kind):
    """ISPRSDataset / ISAIDDataset items (normalised image, int32 label) on
    both sides with the eval transform, and the val split: equal."""
    rng = np.random.default_rng(3)
    names = [f"n{i}" for i in range(5)]
    root = tmp_path / kind
    if kind == "isprs":
        _write_isprs(root, names, (30, 26), rng)
    else:
        (root / "images").mkdir(parents=True)
        (root / "labels").mkdir()
        for nm in names:
            Image.fromarray(rng.integers(0, 256, (30, 26, 3), dtype=np.uint8)).save(
                root / "images" / f"{nm}.png")
            lbl = rng.integers(0, 16, (30, 26)).astype(np.uint8)
            Image.fromarray(np.stack([lbl] * 3, -1) if kind == "isaid_rgb" else lbl).save(
                root / "labels" / f"{nm}.png")
    _split_files(root, names, 2)
    port_cls, jax_cls = (ISPRSDataset, JaxISPRS) if kind == "isprs" else (ISAIDDataset, JaxISAID)
    args = (str(root), str(root / "images"), str(root / "labels"))
    got = port_cls(*args, split="val", transform=EvalAugment(24), val_images=2)
    want = jax_cls(*args, split="val", transform=JaxEvalAugment(24), val_images=2)
    assert len(got) == len(want) == 2
    assert got.NUM_CLASSES == want.NUM_CLASSES
    for i in range(2):
        for g, w in zip(got[i], want[i]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if kind == "isprs":
        assert (got[0][1] == 255).any()


@pytest.mark.parametrize("g_old,g_new", [(4, 6), (6, 4)])
def test_pos_embed_surgery_matches_jax(g_old, g_new):
    """interp_pos_embed (F.interpolate bicubic) against _interp_pos_embed_tree
    (the JAX package's torch-exact bicubic), 1e-6."""
    v = np.random.default_rng(g_old).normal(size=(1, g_old * g_old, 8)).astype(np.float32)
    target = np.zeros((1, g_new * g_new, 8), np.float32)
    want = _interp_pos_embed_tree({"pos_embed": v, "other": v}, {"pos_embed": target})
    got = interp_pos_embed({"pos_embed": torch.from_numpy(v), "other": torch.from_numpy(v)},
                           {"pos_embed": torch.from_numpy(target)})
    assert got["pos_embed"].shape == (1, g_new * g_new, 8)
    np.testing.assert_allclose(got["pos_embed"].numpy(), want["pos_embed"], rtol=1e-6, atol=1e-6)
    assert torch.equal(got["other"], torch.from_numpy(v))


def test_load_pretrained_encoder_resizes_pos_embed(tmp_path):
    """A ViTSeg encoder checkpoint at 32^2 (2x2 grid) grafted into a 64^2
    model: every tensor loaded, pos_embed bicubic-resized."""
    src = ViTSeg(img_size=32, **STEP_VIT)
    with torch.no_grad():
        for p in src.parameters():
            p.normal_()
    path = str(tmp_path / "enc.pt")
    torch.save({"model": src.state_dict()}, path)
    model = TinyPortSeg(size=64)
    load_pretrained_encoder(model, path)
    want = interp_pos_embed(src.state_dict(), model.encoder.state_dict())
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert want["pos_embed"].shape == (1, 16, 32)


# --------------------------------------------------------- evaluate ----


def _seg_pair(num_classes=4, size=32):
    """A flax SegModel (tiny ViTSeg + UperNet 16, one head) with drawn
    variables and the port's SegModel with the same weights."""
    class J(JaxSegModel):
        def setup(self):
            self.encoder = JaxViTSeg(img_size=size, **STEP_VIT)
            self.seg_decoder = JaxUPerHead(channels=16)
            self.head = JaxSegHead(self.num_classes, kernel=1, dropout=0.1)

    jm = J(num_classes=num_classes, image_size=size)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    jvars = draw_variables(shapes, 61)
    model = TinyPortSeg(num_classes, size)
    model.load_state_dict(jax_params_to_torch(jvars["params"], jvars["batch_stats"]), strict=True)
    return jm, jvars, model


def _recording_fwd(log, to_numpy):
    def fwd(batch):
        b = to_numpy(batch)
        log.append(b.copy())
        z = b.sum(-1, keepdims=True) * np.arange(1, 4, dtype=np.float32)
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    return fwd


@pytest.mark.parametrize("hw", [(50, 70), (20, 40), (64, 64)])
def test_scale_process_grid_matches_jax(hw):
    """The crops visited (origins, order, zero-padded tail batch) and the
    averaged map: equal to JAX's scale_process; the grid covers the image."""
    img = np.random.default_rng(hw[0]).normal(size=(*hw, 3)).astype(np.float32)
    got_log, want_log = [], []
    got = evaluate.scale_process(_recording_fwd(got_log, np.asarray), img, 3, 32)
    want = jax_evaluate.scale_process(_recording_fwd(want_log, np.asarray), img, 3, 32)
    assert len(got_log) == len(want_log)
    for g, w in zip(got_log, want_log):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got, want)
    pads, coords = evaluate.crop_grid(*hw, 32)
    cover = np.zeros((hw[0] + pads[0] + pads[1], hw[1] + pads[2] + pads[3]), bool)
    for y, x in coords:
        cover[y:y + 32, x:x + 32] = True
    assert cover.all()


def test_crop_forward_matches_jax():
    """Flip-TTA crop probabilities of the same weights, 1e-5 rel-L2."""
    jm, jvars, model = _seg_pair()
    batch = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_evaluate.make_crop_forward(jm, jvars)(jnp.asarray(batch)))
    got = evaluate.make_crop_forward(model)(batch)
    assert got.shape == want.shape == (3, 32, 32, 4)
    assert _rel_l2(got, want) <= 1e-5


def test_run_test_with_tta_matches_jax(tmp_path):
    """run_test with flip TTA on two images of odd size (crop grids with tail
    crops) against JAX's run_test on the same weights: probabilities 1e-5
    rel-L2, scores and the gray / colour PNGs equal."""
    jm, jvars, model = _seg_pair()
    rng = np.random.default_rng(7)
    data = [(rng.integers(0, 256, hw + (3,), dtype=np.uint8),
             rng.integers(0, 4, hw).astype(np.int32)) for hw in ((40, 56), (33, 47))]
    palette = evaluate.dataset_palette("potsdam")
    want = jax_evaluate.run_test(jm, jvars, data, 4, 32, save_dir=str(tmp_path / "jax"),
                                 palette=palette)
    got = evaluate.run_test(model, data, 4, 32, save_dir=str(tmp_path / "port"), palette=palette)
    for key in ("iou", "f1", "acc"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["miou"] == want["miou"] and got["all_acc"] == want["all_acc"]
    for sub in ("gray", "color"):
        for i in range(2):
            a = np.asarray(Image.open(tmp_path / "port" / sub / f"{i:06d}.png"))
            b = np.asarray(Image.open(tmp_path / "jax" / sub / f"{i:06d}.png"))
            np.testing.assert_array_equal(a, b)
    jfwd = jax_evaluate.make_crop_forward(jm, jvars)
    pfwd = evaluate.make_crop_forward(model)
    for img, _ in data:
        normed = evaluate.normalize_image(img)
        w = jax_evaluate.scale_process(jfwd, normed, 4, 32)
        g = evaluate.predict_probs(pfwd, img, 4, 32)
        assert _rel_l2(g, w) <= 1e-5


def test_multiscale_prediction_matches_jax():
    """Multi-scale TTA through the port's numpy INTER_LINEAR against JAX's
    cv2 path: labels agree on >= 99% of pixels (the image resize is within
    one grey level of cv2's)."""
    jm, jvars, model = _seg_pair()
    img = np.random.default_rng(8).integers(0, 256, (36, 44, 3), dtype=np.uint8)
    scales = (0.75, 1.0, 1.5)
    want = jax_evaluate.predict_image(jax_evaluate.make_crop_forward(jm, jvars), img, 4, 32,
                                      scales)
    got = evaluate.predict_image(evaluate.make_crop_forward(model), img, 4, 32, scales)
    assert got.shape == want.shape == (36, 44)
    assert (got == want).mean() >= 0.99


# ---------------------------------------------------- run_finetune ----


def test_run_finetune_end_to_end_with_sep_graft(tmp_path, caplog):
    """SEP -> finetune: run_pretrain (tiny RVSA, one step) writes
    last_encoder.pt; run_finetune grafts it into a SegModel with the same
    trunk, trains one epoch of one step (lr 0 at step 0, so the encoder is
    still the checkpoint's), evaluates with the tail batch padded, logs the
    epoch line and writes last / best."""
    S = 32
    pre_root = tmp_path / "sota"
    rng = np.random.default_rng(0)
    (pre_root / "images").mkdir(parents=True)
    (pre_root / "labels").mkdir()
    pre_names = [f"s{i}" for i in range(12)]
    for nm in pre_names:
        Image.fromarray(rng.integers(0, 256, (S + 8, S + 8, 3), dtype=np.uint8)).save(
            pre_root / "images" / f"{nm}.png")
        Image.fromarray(rng.integers(0, 18, (S + 8, S + 8), dtype=np.uint8)).save(
            pre_root / "labels" / f"{nm}.png")
    _split_files(pre_root, pre_names, 8)
    args = (str(pre_root), str(pre_root / "images"), str(pre_root / "labels"))
    pcfg = PretrainConfig(total_iters=1, eval_interval=1, seed=0, device="cpu",
                          data=DataConfig(root=str(tmp_path), datasets=("sota",), image_size=S,
                                          batch_size=8, num_workers=2, val_images=4),
                          optim=OptimConfig(warmup_iters=1), ckpt_dir=str(tmp_path / "pre"))
    run_pretrain(pcfg, model=TinyPort((18,), S),
                 datasets_trn={"sota": SegmentationDataset(*args, split="trn",
                                                           transform=TrainAugment(S, seed=0))},
                 datasets_val={"sota": SegmentationDataset(*args, split="val", val_images=4,
                                                           transform=EvalAugment(S))})
    enc_path = tmp_path / "pre" / "last_encoder.pt"
    enc = torch.load(enc_path, weights_only=True)["model"]

    root = tmp_path / "potsdam"
    names = [f"p{i}" for i in range(13)]
    _write_isprs(root, names, (S + 6, S + 6), rng)
    _split_files(root, names, 8)
    cfg = FinetuneConfig(epochs=1, image_size=S, batch_size=8, seed=0, device="cpu",
                         pretrained=str(enc_path),
                         data=DataConfig(root=str(tmp_path), num_workers=2, val_images=5),
                         optim=OptimConfig(lr=1e-3, warmup_iters=2),
                         ckpt_dir=str(tmp_path / "ft"))
    model = TinyPortSeg(6, S, rvsa=True)
    with caplog.at_level(logging.INFO, logger="samrs_tpu_torch.finetune"):
        state = run_finetune(cfg, model=model)
    assert state.step == 1
    for k, v in enc.items():
        assert torch.equal(model.encoder.state_dict()[k], v), k
    lines = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("loaded pretrained encoder") for m in lines)
    epochs = [m for m in lines if m.startswith("epoch 1/1")]
    assert len(epochs) == 1 and 0.0 <= float(epochs[0].split("mIoU ")[1].split()[0]) <= 1.0
    for f in ("last.pt", "best.pt", "last_encoder.pt"):
        assert os.path.exists(tmp_path / "ft" / f), f
    saved = torch.load(tmp_path / "ft" / "last.pt", weights_only=True)
    assert saved["step"] == 1 and 0.0 <= saved["meta"]["miou"] <= 1.0


def test_evaluate_simple_pads_the_tail_batch():
    """Five validation images in batches of 4: the padded tail counts once
    (its ignored labels add nothing), equal to batches of 1."""
    from samrs_tpu_torch.train.finetune import evaluate_simple

    class Data:
        def __init__(self):
            r = np.random.default_rng(4)
            self.items = [(r.normal(size=(32, 32, 3)).astype(np.float32),
                           r.integers(0, 6, (32, 32)).astype(np.int32)) for _ in range(5)]

        def __len__(self):
            return 5

        def __getitem__(self, i):
            return self.items[i]

    model = TinyPortSeg(6, 32)
    a = evaluate_simple(model, Data(), 6, False, batch_size=4)
    b = evaluate_simple(model, Data(), 6, False, batch_size=1)
    np.testing.assert_array_equal(a["iou"], b["iou"])
    assert a["all_acc"] == b["all_acc"]


def test_finetune_config_matches_jax():
    from samrs_tpu.core.config import FinetuneConfig as JaxFinetuneConfig

    over = ["dataset=isaid", "epochs=3", "optim.lr=1e-4", "pretrained=x.pt"]
    want = JaxFinetuneConfig().override(over).to_dict()
    got = FinetuneConfig().override(over)
    assert got.device == "cuda"
    for k, v in want.items():
        g = getattr(got, k)
        g = g.__dict__ if hasattr(g, "__dataclass_fields__") else g
        assert g == v, k
