"""PyTorch port of SEP pretraining (samrs_tpu_torch.train) vs the JAX package,
on CPU in fp32: the pretrain step against ``make_pretrain_step`` with
``build_optimizer``, the optimizer's pieces against optax, the loss and
metrics, the host data pipeline, and ``run_pretrain`` end to end.
"""

import logging
import os
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from torch import nn

from samrs_tpu.core.config import PretrainConfig as JaxPretrainConfig
from samrs_tpu.core.metrics import intersection_and_union as jax_iou
from samrs_tpu.data.datasets import DataLoader as JaxDataLoader
from samrs_tpu.data.transforms import EvalAugment as JaxEvalAugment
from samrs_tpu.data.transforms import TrainAugment as JaxTrainAugment
from samrs_tpu.seg.backbones.rvsa import ViTRVSA as JaxViTRVSA
from samrs_tpu.seg.decoders.upernet import UPerHead as JaxUPerHead
from samrs_tpu.seg.frameworks import MultiHeadSegModel as JaxMultiHead
from samrs_tpu.seg.frameworks import SegHead as JaxSegHead
from samrs_tpu.train import optim as jax_optim
from samrs_tpu.train.pretrain import apply_optim_defaults as jax_apply_optim_defaults
from samrs_tpu.train.trainer import TrainState as JaxTrainState
from samrs_tpu.train.trainer import cross_entropy_ignore as jax_ce
from samrs_tpu.train.trainer import make_pretrain_step
from samrs_tpu_torch.core.config import DataConfig, OptimConfig, PretrainConfig
from samrs_tpu_torch.core.metrics import intersection_and_union, segmentation_scores
from samrs_tpu_torch.data.datasets import DataLoader, SegmentationDataset
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment, _resize
from samrs_tpu_torch.nn.layers import DropPath, Dropout
from samrs_tpu_torch.seg.backbones.rvsa import ViTRVSA
from samrs_tpu_torch.seg.decoders.upernet import UPerHead
from samrs_tpu_torch.seg.frameworks import MultiHeadSegModel, SegHead
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.train import optim
from samrs_tpu_torch.train.pretrain import (apply_optim_defaults, proportional_batch_sizes,
                                            run_pretrain)
from samrs_tpu_torch.train.trainer import TrainState, cross_entropy_ignore, pretrain_step
from test_torch_port_seg import TINY_RVSA, _rel_l2, draw_variables

TOL = 1e-4  # fp32 both sides; only summation order differs
CLASSES = (3, 4, 5)
SIZE = 80  # 5x5 tokens, padded symmetrically to one 7x7 window
LR, WARMUP, TOTAL, OFFSET = 6e-5, 2, 20, 5  # default peak lr; the schedule starts past its warmup
# per-head batches of >= 3: the 1x1 PPM branch's BatchNorm sees one value per
# image, and with fewer its statistics turn rounding into whole differences
# (2 normalise to +-1, whose gradient is pure rounding).  The batch of 1 (zero
# variance) has its own test.
BATCH = (4, 3, 5)
# parameters with no true gradient: the per-channel shifts the next layer's
# BatchNorm removes (the neck's last deconv biases) and the key bias of the
# full-attention block (softmax is blind to q.b_k).  Both packages return
# rounding noise there, which Adam turns into lr-sized steps that part the two
# runs; the step test holds these coordinates' gradients to zero on both sides
# (and checks that they are noise).
ZERO_GRAD = {"encoder.fpn1.3.bias": slice(None), "encoder.fpn2.0.bias": slice(None),
             "encoder.blocks.2.attn.qkv.bias": slice(32, 64)}


def _keep_masks(named_shapes):
    """name -> 0/1 float mask, 0 on the ZERO_GRAD coordinates."""
    out = {}
    for name, shape in named_shapes.items():
        m = np.ones(shape, np.float32)
        if name in ZERO_GRAD:
            m[ZERO_GRAD[name]] = 0.0
        out[name] = m
    return out


class TinyJax(JaxMultiHead):
    def setup(self):
        self._block_remat = False
        self.encoder = JaxViTRVSA(img_size=SIZE, **TINY_RVSA)
        self.seg_decoder = JaxUPerHead(channels=16)
        self.heads = [JaxSegHead(nc, kernel=1, dropout=0.0, name=f"head_{i}")
                      for i, nc in enumerate(self.num_classes)]


class TinyPort(MultiHeadSegModel):
    """The port's MultiHeadSegModel with a width-32 RVSA trunk (two RVSA
    blocks, one full), a 16-wide UperNet and no dropout or drop-path (the two
    packages' random streams differ)."""

    def __init__(self, num_classes=CLASSES, size=SIZE):
        nn.Module.__init__(self)
        self.use_kernels = True
        self.num_classes = tuple(num_classes)
        self.encoder = ViTRVSA(img_size=size, **TINY_RVSA)
        self.seg_decoder = UPerHead(self.encoder.out_channels[1:], channels=16)
        self.heads = nn.ModuleList(SegHead(16, nc, 1, dropout=0.0) for nc in self.num_classes)


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for b, nc in zip(BATCH, CLASSES):
        x = rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.integers(0, nc, (b, SIZE, SIZE)).astype(np.int32)
        y[:, :7] = 255  # some ignored pixels
        out.append((x, y))
    return out


def _adam_state(opt_state):
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s))


def _to_flax(mask, shape):
    """A port-layout 0/1 mask in a flax leaf's layout (1-D masks only differ)."""
    return mask.reshape(shape) if mask.ndim == 1 else np.ones(shape, np.float32)


@pytest.fixture(scope="module")
def train_run():
    """Three pretrain steps on both sides from the same numpy-drawn state;
    snapshots after steps 1 and 3, and the first step's raw gradients."""
    jm = TinyJax(num_classes=CLASSES, image_size=SIZE)
    xs0 = [jnp.zeros((1, SIZE, SIZE, 3))] * 3
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xs0, True))
    jvars = draw_variables(shapes, 21)
    params, stats = jvars["params"], jvars["batch_stats"]
    jsched = jax_optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    tx = jax_optim.build_optimizer(params, lambda c: jsched(c + OFFSET), weight_decay=0.05,
                                   grad_clip=5.0, layer_decay=0.9, num_layers=3)
    model = TinyPort()
    model.load_state_dict(jax_params_to_torch(params, stats), strict=True)
    keep = _keep_masks({n: tuple(p.shape) for n, p in model.named_parameters()})
    for n, p in model.named_parameters():
        if n in ZERO_GRAD:
            p.register_hook(lambda g, m=torch.from_numpy(keep[n]): g * m)
    # the same masks in flax layout: bridge a tree of indices, then look them up
    flat_idx = {k: np.full(np.shape(v), i, np.float32) for i, (k, v) in enumerate(
        flax.traverse_util.flatten_dict(params).items())}
    by_idx = {int(v.reshape(-1)[0]): n for n, v in jax_params_to_torch(
        flax.traverse_util.unflatten_dict(flat_idx)).items()}
    jkeep = flax.traverse_util.unflatten_dict({
        k: _to_flax(keep[by_idx[i]], v.shape) for i, (k, v) in enumerate(
            flax.traverse_util.flatten_dict(params).items())})
    tx = optax.chain(optax.stateless(lambda u, _: jax.tree_util.tree_map(
        lambda a, m: a * m, u, jkeep)), tx)
    jstate = JaxTrainState.create(params, stats, tx)
    jstep = make_pretrain_step(jm, tx)
    psched = optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    opt = optim.Optimizer(model, lambda s: psched(s + OFFSET), weight_decay=0.05, grad_clip=5.0,
                          layer_decay=0.9, num_layers=3)
    state = TrainState(0, model, opt)

    # the first step's raw gradients, before any clipping
    b0 = _batches(0)

    def loss_fn(p):
        outs, _ = jm.apply({"params": p, "batch_stats": stats}, [jnp.asarray(x) for x, _ in b0],
                           True, mutable=["batch_stats"])
        return sum(jax_ce(o, jnp.asarray(y)) for o, (_, y) in zip(outs, b0))

    jgrads = jax.jit(jax.grad(loss_fn))(params)  # no masks: the raw gradients
    model.train()
    outs = model([torch.from_numpy(x) for x, _ in b0])
    sum(cross_entropy_ignore(o, torch.from_numpy(y)) for o, (_, y) in zip(outs, b0)).backward()
    pgrads = {n: p.grad.clone() for n, p in model.named_parameters()}  # masked
    model.load_state_dict(jax_params_to_torch(params, stats), strict=True)  # undo BN updates
    opt.zero_grad()

    snaps = {}
    for i in range(3):
        b = _batches(i)
        jstate, jm_ = jstep(jstate, tuple((jnp.asarray(x), jnp.asarray(y)) for x, y in b),
                            jax.random.PRNGKey(0))
        pm = pretrain_step(state, [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in b], 0)
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


def test_first_step_gradients_match_jax(train_run):
    """Every parameter's gradient of the summed three-head loss, the sampling
    nets included (they get one only through K8's coordinate derivative)."""
    jgrads, pgrads, _ = train_run
    assert set(jgrads) == set(pgrads)
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jgrads.values()))
    for k, v in jgrads.items():
        g, w = pgrads[k].numpy().copy(), v.numpy().copy()
        if k in ZERO_GRAD:  # rounding noise in JAX, held to zero in the port
            assert np.abs(w[ZERO_GRAD[k]]).max() <= 1e-6 * total, k
            assert not g[ZERO_GRAD[k]].any(), k
            g[ZERO_GRAD[k]] = w[ZERO_GRAD[k]] = 0.0
            if not w.any():
                continue
        assert _rel_l2(g, w) <= TOL, (k, _rel_l2(g, w))
    assert any(".sampling_offsets." in k for k in jgrads)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_pretrain_steps_match_make_pretrain_step(train_run, n_steps):
    """Loss, parameters, BatchNorm running statistics and both Adam moments
    after one and after three steps (layer-decay AdamW, clip 5, lr > 0)."""
    snap = train_run[2][n_steps]
    assert abs(snap["ploss"] - snap["jloss"]) <= TOL * abs(snap["jloss"])
    assert set(snap["jstate"]) == set(snap["pstate"])
    for k, v in snap["jstate"].items():
        assert _rel_l2(snap["pstate"][k].numpy(), v.numpy()) <= TOL, k
    for moment in ("mu", "nu"):
        want, got = snap["j" + moment], snap["p" + moment]
        assert set(want) == set(got)
        for k, v in want.items():
            if not v.any():  # a ZERO_GRAD tensor: no moment on either side
                assert not got[k].any(), (moment, k)
                continue
            assert _rel_l2(got[k].numpy(), v.numpy()) <= TOL, (moment, k)


def test_batchnorm_one_value_per_channel_matches_flax():
    """A batch of 1 after the 1x1 pool: zero variance, output = bias, and the
    running statistics updated as flax updates them."""
    from flax import linen as fnn

    from samrs_tpu_torch.seg.decoders.blocks import BatchNorm

    x = np.random.default_rng(9).normal(size=(1, 1, 1, 6)).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    jv = draw_variables(jax.eval_shape(lambda: jbn.init(jax.random.PRNGKey(0), x)), 2)
    want, upd = jbn.apply(jv, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(jv["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(jv["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(jv["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(jv["batch_stats"]["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = bn(xt)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    got.sum().backward()
    assert not xt.grad.any()
    for k, t in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(t.numpy(), np.asarray(upd["batch_stats"][k]), rtol=1e-6)


def test_dropout_and_drop_path_follow_the_generator():
    x = torch.ones(1024, 3, 4, 5)
    for layer, rate in ((DropPath(0.25), 0.25), (Dropout(0.1), 0.1)):
        a = layer(x, torch.Generator().manual_seed(3))
        b = layer(x, torch.Generator().manual_seed(3))
        c = layer(x, torch.Generator().manual_seed(4))
        assert torch.equal(a, b) and not torch.equal(a, c)
        kept = a != 0
        assert torch.allclose(a[kept], torch.full_like(a[kept], 1.0 / (1.0 - rate)))
        assert abs(kept.float().mean().item() - (1.0 - rate)) < 0.1
        if isinstance(layer, DropPath):  # one draw per sample
            assert bool((kept.flatten(1).all(1) | ~kept.flatten(1).any(1)).all())
        assert torch.equal(layer.eval()(x, torch.Generator().manual_seed(3)), x)


def test_optimizer_groups_match_optax():
    """Layer ids (-> lr scale) and the weight-decay mask of every parameter."""
    jm = TinyJax(num_classes=CLASSES, image_size=SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, SIZE, SIZE, 3))] * 3, True))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    scales = jax_optim.layer_decay_scales(params, 0.9, 3)
    decay = jax.tree_util.tree_map_with_path(
        lambda p, v: np.full(v.shape, float(not jax_optim.no_weight_decay(
            jax_optim._path_str(p), v)), np.float32), params)
    want_scale = jax_params_to_torch(jax.tree_util.tree_map(
        lambda s, p: np.full(p.shape, s, np.float32), scales, params))
    want_decay = jax_params_to_torch(decay)
    model = TinyPort()
    for name, p in model.named_parameters():
        assert optim.layer_decay_scale(name, 0.9, 3) == pytest.approx(
            float(want_scale[name].reshape(-1)[0]), rel=1e-6), name
        assert (not optim.no_weight_decay(name, p)) == bool(want_decay[name].reshape(-1)[0]), name
    opt = optim.Optimizer(model, lambda s: 1e-3, layer_decay=0.9, num_layers=3)
    opt.step(0)  # no grads yet: lr set per group
    for g in opt.opt.param_groups:
        assert g["lr"] == pytest.approx(1e-3 * g["lr_scale"])


def test_sgd_matches_optax():
    """optimizer="sgd": clip, trace(0.9), decay on the pre-update weights
    (matrices only), lr; three updates."""
    rng = np.random.default_rng(6)
    w, b = rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)
    params = {"fc": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}}
    tx = jax_optim.build_optimizer(params, lambda c: 0.1, weight_decay=0.05, grad_clip=1.0,
                                   optimizer="sgd")
    state = tx.init(params)
    model = nn.Sequential()
    model.add_module("fc", nn.Linear(3, 4))
    with torch.no_grad():
        model.fc.weight.copy_(torch.from_numpy(w))
        model.fc.bias.copy_(torch.from_numpy(b))
    opt = optim.Optimizer(model, lambda s: 0.1, weight_decay=0.05, grad_clip=1.0,
                          optimizer="sgd")
    for it in range(3):
        gw, gb = rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)
        upd, state = tx.update({"fc": {"kernel": jnp.asarray(gw.T), "bias": jnp.asarray(gb)}},
                               state, params)
        params = optax.apply_updates(params, upd)
        model.fc.weight.grad, model.fc.bias.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        opt.step(it)
    np.testing.assert_allclose(model.fc.weight.detach().numpy(),
                               np.asarray(params["fc"]["kernel"]).T, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(model.fc.bias.detach().numpy(), np.asarray(params["fc"]["bias"]),
                               rtol=1e-6, atol=1e-7)


def test_schedule_matches_optax():
    for args in ((6e-5, 30, 5, 0.0), (1e-3, 10, 0, 0.1), (2e-4, 3, 8, 0.0)):
        want = jax_optim.warmup_cosine_schedule(*args)
        got = optim.warmup_cosine_schedule(*args)
        for step in range(0, 40):
            assert got(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-12), (args, step)
    assert optim.warmup_cosine_schedule(1e-3, 100, 10)(0) == 0.0  # the first step runs at lr 0


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(2)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    optim.clip_by_global_norm(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 6, 7)).astype(np.int32)
    labels[0, :2] = 255
    got = cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(jax_ce(jnp.asarray(logits), jnp.asarray(labels))),
                                       rel=1e-6)
    ignored = torch.full((2, 6, 7), 255)
    assert float(cross_entropy_ignore(torch.from_numpy(logits), ignored)) == 0.0
    pred = logits.argmax(-1)
    got = intersection_and_union(torch.from_numpy(pred), torch.from_numpy(labels), 5)
    want = jax_iou(jnp.asarray(pred), jnp.asarray(labels), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    s = segmentation_scores(*[g.numpy().astype(float) for g in got])
    assert 0.0 <= s["miou"] <= 1.0


def test_config_and_optim_defaults_match_jax():
    over = ["optim.lr=1e-4", "data.datasets=sota,fast", "total_iters=7", "resume=best"]
    want = jax_apply_optim_defaults(JaxPretrainConfig().override(over), over)
    got = apply_optim_defaults(PretrainConfig().override(over), over)
    assert got.device == "cuda"
    wd = want.to_dict()
    for k, v in wd.items():
        g = getattr(got, k)
        g = g.__dict__ if hasattr(g, "__dataclass_fields__") else g
        assert g == v, k


def test_proportional_batch_sizes():
    assert proportional_batch_sizes(("sota", "sior", "fast"), 96) == {
        "sota": 17, "sior": 12, "fast": 65}


# ------------------------------------------------------------- data ----


@pytest.mark.parametrize("hw", [(40, 40, 60, 60), (37, 53, 71, 29), (100, 80, 55, 133)])
def test_resize_matches_cv2(hw):
    """INTER_LINEAR within 1 grey level (cv2 rounds its weights to 11 bits),
    INTER_NEAREST equal."""
    import cv2

    H, W, h, w = hw
    rng = np.random.default_rng(H)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    mask = rng.integers(0, 20, (H, W), dtype=np.uint8)
    got = _resize(img, (h, w), False).astype(int)
    assert np.abs(got - cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)).max() <= 1
    np.testing.assert_array_equal(_resize(mask, (h, w), True),
                                  cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST))


def test_eval_augment_equal():
    rng = np.random.default_rng(4)
    for shape in ((40, 50), (20, 28)):
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        lbl = rng.integers(0, 9, shape, dtype=np.uint8)
        for g, w in zip(EvalAugment(32)(img, lbl), JaxEvalAugment(32)(img, lbl)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(6))
def test_train_augment_same_draws(seed):
    """One rng gives both the same scale, crop, flips, rotation and
    photometric draw: labels equal, images within the resize's grey level
    (3 after a photometric step that scales it)."""
    img = np.random.default_rng(100 + seed).integers(0, 256, (48, 44, 3), dtype=np.uint8)
    lbl = np.random.default_rng(200 + seed).integers(0, 9, (48, 44), dtype=np.uint8)
    gi, gl = TrainAugment(32, rng=np.random.default_rng(seed))(img, lbl)
    wi, wl = JaxTrainAugment(32, rng=np.random.default_rng(seed))(img, lbl)
    np.testing.assert_array_equal(gl, wl)
    assert gi.shape == wi.shape == (32, 32, 3)
    assert np.abs(gi.astype(int) - wi).max() <= 3


class _IndexDataset:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.float32), np.full((2, 2), i, np.int32)


def test_dataloader_order_matches_jax():
    ds = _IndexDataset()
    got = DataLoader(ds, batch_size=4, seed=5, num_threads=2)
    want = JaxDataLoader(ds, batch_size=4, seed=5, num_threads=2)
    assert len(got) == len(want) == 5
    for _ in range(2):  # two epochs
        for (gx, gy), (wx, wy) in zip(got, want, strict=True):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


# ----------------------------------------------------- run_pretrain ----


def _make_seg_dataset(tmp_path, name, size=32, n_train=12, n_val=8, n_classes=5):
    root = tmp_path / name
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(len(name))
    names = [f"{name}_{i}" for i in range(n_train + n_val)]
    for nm in names:
        Image.fromarray(rng.integers(0, 256, (size + 8, size + 8, 3), dtype=np.uint8)).save(
            root / "images" / f"{nm}.png")
        Image.fromarray(rng.integers(0, n_classes, (size + 8, size + 8), dtype=np.uint8)).save(
            root / "labels" / f"{nm}.png")
    (root / "train.txt").write_text("\n".join(names[:n_train]))
    (root / "valid.txt").write_text("\n".join(names[n_train:]))
    return root


def test_run_pretrain_refuses_pretrained_with_its_roadmap_item(tmp_path, caplog):
    """``pretrained=`` (once refused, ROADMAP.md Queue 1 item 2) now grafts a
    reference-layout ``.pth`` into the encoder before the optimizer: a MAE-
    style checkpoint of the tiny RVSA trunk (``module.backbone.`` prefixes,
    ``mask_token``, a decoder key) loads its trunk, the RVSA sampling nets
    and the neck keep their init, and the first step (lr 0 at step 0) is
    finite and leaves the loaded weights as they were."""
    size = 32
    roots = {n: _make_seg_dataset(tmp_path, n, size) for n in ("sota", "sior")}
    ds = lambda split, aug: {n: SegmentationDataset(str(r), str(r / "images"), str(r / "labels"),
                                                    split=split, transform=aug, val_images=8)
                             for n, r in roots.items()}
    model = TinyPort((18, 20), size)
    rng = np.random.default_rng(4)
    ckpt = {f"module.backbone.{k}": torch.from_numpy(
        (0.05 * rng.normal(size=tuple(v.shape))).astype(np.float32))
        for k, v in model.encoder.state_dict().items()}
    ckpt["module.backbone.mask_token"] = torch.zeros(1, 1, 32)
    ckpt["module.backbone.decoder_embed.weight"] = torch.zeros(16, 32)
    path = str(tmp_path / "mae.pth")
    torch.save({"model": ckpt}, path)
    before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    cfg = PretrainConfig(total_iters=1, eval_interval=1, seed=0, device="cpu", pretrained=path,
                         data=DataConfig(root=str(tmp_path), datasets=("sota", "sior"),
                                         image_size=size, batch_size=16, num_workers=2,
                                         val_images=8),
                         optim=OptimConfig(lr=1e-3, warmup_iters=2),
                         ckpt_dir=str(tmp_path / "ckpt"))
    with caplog.at_level(logging.INFO, logger="samrs_tpu_torch"):
        state = run_pretrain(cfg, model=model, datasets_trn=ds("trn", TrainAugment(size, seed=0)),
                             datasets_val=ds("val", EvalAugment(size)))
    assert state.step == 1
    trunk = re.compile(r"patch_embed\.proj\.|blocks\.\d+\.(norm[12]\.|attn\.(qkv\.|proj\.|rel_pos_)"
                       r"|mlp\.fc[12]\.)")
    after = model.encoder.state_dict()
    for k, v in before.items():
        want = ckpt[f"module.backbone.{k}"] if trunk.match(k) else v
        assert torch.equal(after[k], want), k
    # the patch embedding, 12 tensors a block, the rel-pos tables of the blocks that have them
    n_rel = sum(".rel_pos_" in k for k in before)
    assert n_rel == 4 and sum(bool(trunk.match(k)) for k in before) == 2 + 12 * 3 + n_rel
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("[vit] loaded 42 tensors, skipped 24 ") for m in msgs), msgs
    loss = [float(m.split("loss ")[1].split()[0]) for m in msgs if m.startswith("iter 1/1 loss")]
    assert len(loss) == 1 and np.isfinite(loss[0])


def test_run_pretrain_end_to_end_and_resume(tmp_path, caplog):
    """Two datasets, the tiny model, 4 iterations with an eval every 2,
    checkpoints, then a resume from ``last`` that restores the step."""
    size = 32
    roots = {n: _make_seg_dataset(tmp_path, n, size) for n in ("sota", "sior")}
    ds = lambda split, aug: {n: SegmentationDataset(str(r), str(r / "images"), str(r / "labels"),
                                                    split=split, transform=aug, val_images=8)
                             for n, r in roots.items()}
    cfg = PretrainConfig(total_iters=4, eval_interval=2, seed=0, device="cpu",
                         data=DataConfig(root=str(tmp_path), datasets=("sota", "sior"),
                                         image_size=size, batch_size=16, num_workers=2,
                                         val_images=8),
                         optim=OptimConfig(lr=1e-3, warmup_iters=2),
                         ckpt_dir=str(tmp_path / "ckpt"))
    model = TinyPort((18, 20), size)
    trn = ds("trn", TrainAugment(size, rng=np.random.default_rng(0)))
    val = ds("val", EvalAugment(size))
    with caplog.at_level(logging.INFO, logger="samrs_tpu_torch.pretrain"):
        state = run_pretrain(cfg, model=model, datasets_trn=trn, datasets_val=val)
    assert state.step == 4
    for f in ("last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"):
        assert os.path.exists(tmp_path / "ckpt" / f), f
    vals = [r.getMessage() for r in caplog.records if r.getMessage().startswith("val[")]
    assert len(vals) == 4 and {v.split("]")[0] for v in vals} == {"val[sota", "val[sior"}
    after = {k: v.clone() for k, v in model.state_dict().items()}

    resumed = TinyPort((18, 20), size)
    cfg2 = PretrainConfig(**{**cfg.__dict__, "resume": "last", "total_iters": 5})
    state2 = run_pretrain(cfg2, model=resumed, datasets_trn=trn, datasets_val=val, max_iters=4)
    assert state2.step == 4  # restored, nothing left to run
    for k, v in after.items():
        assert torch.equal(resumed.state_dict()[k], v), k
    state3 = run_pretrain(cfg2, model=resumed, datasets_trn=trn, datasets_val=val)
    assert state3.step == 5


def test_lars_matches_optax():
    """optimizer="lars": three updates of the tiny model's parameters with
    drawn gradients against build_optimizer(..., "lars") (optax.lars after
    the clip: decay on the masked weights, the trust ratio per tensor, lr,
    trace(0.9)); the updates and the parameters within 1e-6."""
    jm = TinyJax(num_classes=CLASSES, image_size=SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, SIZE, SIZE, 3))] * 3, True))
    jvars = draw_variables(shapes, 8)
    params = jvars["params"]
    # one zero parameter: its norm is 0, so its trust ratio is 1
    params = flax.traverse_util.unflatten_dict({
        k: np.zeros_like(v) if k == ("head_0", "conv", "bias") else v
        for k, v in flax.traverse_util.flatten_dict(params).items()})
    sched = lambda c: 0.5 / (1.0 + c)
    tx = jax_optim.build_optimizer(params, sched, weight_decay=0.05, grad_clip=1.0,
                                   optimizer="lars", layer_decay=0.9, num_layers=3)
    state = tx.init(params)
    model = TinyPort()
    model.load_state_dict(jax_params_to_torch(params, jvars["batch_stats"]), strict=True)
    opt = optim.Optimizer(model, sched, weight_decay=0.05, grad_clip=1.0, optimizer="lars",
                          layer_decay=0.9, num_layers=3)
    rng = np.random.default_rng(9)
    flat = flax.traverse_util.flatten_dict(params)
    for it in range(3):
        jgrads = flax.traverse_util.unflatten_dict(
            {k: rng.normal(size=v.shape).astype(np.float32) for k, v in flat.items()})
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        upd, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, upd)
        for n, g in jax_params_to_torch(jgrads).items():
            dict(model.named_parameters())[n].grad = g.clone()
        opt.step(it)
        want_upd, want = jax_params_to_torch(upd), jax_params_to_torch(params)
        for n, p in model.named_parameters():
            np.testing.assert_allclose((p.detach() - before[n]).numpy(), want_upd[n].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{n} update step {it}")
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{n} step {it}")
