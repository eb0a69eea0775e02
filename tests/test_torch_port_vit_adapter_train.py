"""ViT-Adapter-B training in the PyTorch port vs the JAX package, on CPU in
fp32: the optimizer row (lr, weight decay, layer decay) and every parameter's
layer id and decay flag under the reference key layout, the defaults of
``samrs_tpu_torch.train.pretrain``, one whole SEP step of ViT-Adapter + UperNet (three heads,
on flax variables drawn with numpy and bridged with ``jax_params_to_torch``)
against ``make_pretrain_step``: losses, first-step gradients, updated
parameters and BatchNorm statistics; and ``run_pretrain`` end to end with
UNet++.  The modules are in test_torch_port_vit_adapter.py; the same step
with the UNet decoders in test_torch_port_unet.py.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from samrs_tpu.core.config import PretrainConfig as JaxPretrainConfig
from samrs_tpu.seg.backbones import vit_adapter as jax_va
from samrs_tpu.seg.decoders.unet import UnetDecoder as JaxUnet
from samrs_tpu.seg.decoders.unetpp import UnetPlusPlusDecoder as JaxUnetPP
from samrs_tpu.seg.decoders.upernet import UPerHead as JaxUPerHead
from samrs_tpu.seg.frameworks import MultiHeadSegModel as JaxMultiHead
from samrs_tpu.seg.frameworks import SegHead as JaxSegHead
from samrs_tpu.train import optim as jax_optim
from samrs_tpu.train.pretrain import apply_optim_defaults as jax_apply_optim_defaults
from samrs_tpu.train.trainer import TrainState as JaxTrainState
from samrs_tpu.train.trainer import make_pretrain_step
from samrs_tpu_torch.core.config import PretrainConfig
from samrs_tpu_torch.data.datasets import SegmentationDataset
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment
from samrs_tpu_torch.seg.backbones import vit_adapter
from samrs_tpu_torch.seg.decoders.unet import UnetDecoder
from samrs_tpu_torch.seg.decoders.unetpp import UnetPlusPlusDecoder
from samrs_tpu_torch.seg.decoders.upernet import UPerHead
from samrs_tpu_torch.seg.frameworks import MultiHeadSegModel, SegHead
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.seg.registry import get_backbone
from samrs_tpu_torch.train import optim
from samrs_tpu_torch.train.pretrain import apply_optim_defaults, run_pretrain
from samrs_tpu_torch.train.trainer import TrainState, pretrain_step
from test_torch_port_seg import _rel_l2, draw_variables
from test_torch_port_train import _adam_state, _make_seg_dataset
from test_torch_port_vit_adapter import INTERACTIONS, NO_GRAD, SIZE, TINY, TOL

UNET_CHANNELS = (32, 16, 8, 8)


class TinyJax(JaxMultiHead):
    def setup(self):
        self._block_remat = False
        self.encoder = jax_va.ViTAdapter(**TINY, interaction_indexes=INTERACTIONS[2])
        if self.decoder == "upernet":
            self.seg_decoder = JaxUPerHead(channels=16)
        else:
            self.seg_decoder = {"unet": JaxUnet, "unetpp": JaxUnetPP}[self.decoder](UNET_CHANNELS)
        kernel = 1 if self.decoder == "upernet" else 3
        self.heads = [JaxSegHead(nc, kernel=kernel, dropout=0.0, name=f"head_{i}")
                      for i, nc in enumerate(self.num_classes)]


class TinyPort(MultiHeadSegModel):
    """The port's MultiHeadSegModel with a tiny ViT-Adapter (2 interactions)
    and a 16-wide UperNet, or a tiny UNet / UNet++ with the 3x3 heads,
    without dropout or drop-path (the two packages' random streams
    differ)."""

    def __init__(self, num_classes=(3, 4, 5), decoder="upernet"):
        nn.Module.__init__(self)
        self.use_kernels = True
        self.backbone, self.decoder = "vit_adapter_b", decoder
        self.num_classes = tuple(num_classes)
        self.encoder = vit_adapter.ViTAdapter(**TINY, interaction_indexes=INTERACTIONS[2])
        ch = self.encoder.out_channels[1:]
        if decoder == "upernet":
            self.seg_decoder = UPerHead(ch, channels=16)
            self.heads = nn.ModuleList(SegHead(16, nc, 1) for nc in self.num_classes)
        else:
            dec = {"unet": UnetDecoder, "unetpp": UnetPlusPlusDecoder}[decoder]
            self.seg_decoder = dec(ch, UNET_CHANNELS)
            self.heads = nn.ModuleList(SegHead(UNET_CHANNELS[-1], nc, 3)
                                       for nc in self.num_classes)


def _zero_params(jm, n_heads=3):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, SIZE, SIZE, 3))] * n_heads, True))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])


def test_optimizer_row_layer_ids_and_decay_match_jax():
    """``backbone_optim_settings("vit_adapter_b")`` (lr 6e-5, wd 0.01, layer
    decay 0.95, the vit scheme, 12 layers from the encoder) equals JAX's, and
    every parameter's lr scale and decay flag under the reference key layout
    equals JAX's ``vit_layer_id`` / ``no_weight_decay`` on the flax names:
    the spatial prior (its stem too), level_embed, the interactions, up and
    the norms L+1, blocks.{i} (their gammas too) i+1, pos / patch embedding
    0; the gammas are 1-D (no decay), level_embed 2-D (decays)."""
    with torch.device("meta"):
        enc = get_backbone("vit_adapter_b")
    got = optim.backbone_optim_settings("vit_adapter_b", enc)
    want = jax_optim.backbone_optim_settings("vit_adapter_b", jax_va.vit_adapter_b())
    assert got == want
    assert (got["lr"], got["weight_decay"], got["layer_decay"], got["num_layers"]) == \
        (6e-5, 0.01, 0.95, 12)
    jm = TinyJax(num_classes=(3, 4, 5), image_size=SIZE)
    params = _zero_params(jm)
    L = 4
    scales = jax_optim.layer_decay_scales(params, 0.95, L)
    decay = jax.tree_util.tree_map_with_path(lambda p, v: np.full(v.shape, float(
        not jax_optim.no_weight_decay(jax_optim._path_str(p), v)), np.float32), params)
    want_scale = jax_params_to_torch(jax.tree_util.tree_map(
        lambda s, p: np.full(p.shape, s, np.float32), scales, params))
    want_decay = jax_params_to_torch(decay)
    model = TinyPort()
    for name, p in model.named_parameters():
        assert optim.layer_decay_scale(name, 0.95, L) == pytest.approx(
            float(want_scale[name].reshape(-1)[0]), rel=1e-6), name
        assert (not optim.no_weight_decay(name, p)) == bool(want_decay[name].reshape(-1)[0]), name
    ids = {n: optim.vit_layer_id(n, L) for n, _ in model.named_parameters()}
    assert ids["encoder.spm.stem.0.weight"] == ids["encoder.level_embed"] == L + 1
    assert ids["encoder.blocks.2.gamma1"] == 3 and ids["encoder.pos_embed"] == 0
    assert not optim.no_weight_decay("encoder.level_embed", model.encoder.level_embed)


def test_apply_optim_defaults_matches_jax():
    """The pretrain driver folds the family's lr / wd / layer decay into its
    config as JAX's does, explicit overrides kept."""
    for over in (["backbone=vit_adapter_b", "decoder=unetpp"],
                 ["backbone=vit_adapter_b", "decoder=unet", "optim.lr=1e-4"]):
        want = jax_apply_optim_defaults(JaxPretrainConfig().override(over), over).to_dict()
        got = apply_optim_defaults(PretrainConfig().override(over), over)
        for k, v in want.items():
            g = getattr(got, k)
            assert (g.__dict__ if hasattr(g, "__dataclass_fields__") else g) == v, k


# --------------------------------------------------------- SEP step ----


# >= 3 a head: the 1x1 PPM branch's BatchNorm sees one value per image (as
# test_torch_port_train.py's step)
BATCH = (4, 3, 5)
CLASSES = (3, 4, 5)
LR, WARMUP, TOTAL, OFFSET = 6e-5, 2, 20, 5  # the row's peak lr; the schedule past its warmup
# the whole model's fp32 gradient sits on ReLU / BatchNorm kinks that rounding decides:
# JAX's own gradients at the images scaled by 1 and by 1 + 1e-7 are 1.3e-2 apart in 12
# spatial-prior parameters (a straddled ReLU in its stem) and the port's, at 1, lies on
# the 1 + 1e-7 side; so JAX's step takes the images scaled by 1 + JAX_SIDE, the port's
# the images as drawn, and every parameter is held to TOL there (worst 7.9e-5)
JAX_SIDE = 1e-7
# the per-channel shifts that a BatchNorm removes next, beyond NO_GRAD's: UperNet's
# lateral 1x1 convs (no bias) and BatchNorms follow norm1..norm3
NO_GRAD_UPERNET = NO_GRAD + ("norm1.bias", "norm2.bias", "norm3.bias")


def sep_first_step(decoder, jax_side=0.0, grad_clip=5.0, seed=21):
    """One SEP step of a tiny ViT-Adapter + `decoder` from the same
    numpy-drawn state through JAX's ``make_pretrain_step`` and the port's
    ``pretrain_step``: the three heads in head order, their summed
    cross-entropy, layer-decay AdamW with the vit_adapter_b row's weight
    decay and layer decay (0.01, 0.95 over the 4 blocks), `grad_clip`;
    JAX's images scaled by 1 + `jax_side`.  Returns both sides in the port's
    names: each head's loss, the parameters and BatchNorm statistics after
    the step, and Adam's first moment, which after one step is 0.1 x the
    (clipped) gradient."""
    jm = TinyJax(num_classes=CLASSES, decoder=decoder, image_size=SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, SIZE, SIZE, 3))] * 3, True))
    jvars = draw_variables(shapes, seed)
    rng = np.random.default_rng(seed + 1)
    batches = []
    for b, nc in zip(BATCH, CLASSES):
        y = rng.integers(0, nc, (b, SIZE, SIZE)).astype(np.int32)
        y[:, :5] = 255  # some ignored pixels
        batches.append((rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32), y))
    kw = dict(weight_decay=0.01, grad_clip=grad_clip, layer_decay=0.95, num_layers=TINY["depth"])
    jsched = jax_optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    tx = jax_optim.build_optimizer(jvars["params"], lambda c: jsched(c + OFFSET), **kw)
    model = TinyPort(CLASSES, decoder)
    model.load_state_dict(jax_params_to_torch(jvars["params"], jvars["batch_stats"]), strict=True)
    psched = optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    state = TrainState(0, model, optim.Optimizer(model, lambda s: psched(s + OFFSET), **kw))
    jstate, jmetrics = make_pretrain_step(jm, tx)(
        JaxTrainState.create(jvars["params"], jvars["batch_stats"], tx),
        tuple((jnp.asarray(x * np.float32(1 + jax_side)), jnp.asarray(y)) for x, y in batches),
        jax.random.PRNGKey(0))
    pmetrics = pretrain_step(state, [(torch.from_numpy(x), torch.from_numpy(y))
                                     for x, y in batches], 0)
    names = {p: n for n, p in model.named_parameters()}
    return dict(
        jloss=[float(jmetrics[f"loss_{i}"]) for i in range(3)],
        ploss=[float(pmetrics[f"loss_{i}"]) for i in range(3)],
        jstate=jax_params_to_torch(jstate.params, jstate.batch_stats),
        pstate={k: v.clone() for k, v in model.state_dict().items()},
        jmu=jax_params_to_torch(_adam_state(jstate.opt_state).mu),
        pmu={names[p]: s["exp_avg"].clone() for p, s in state.optimizer.opt.state.items()},
        stats={k for k, _ in model.named_buffers()})


def assert_sep_losses_and_stats(run, want_stats):
    """Each head's loss within 1e-5; every BatchNorm's running statistics
    after the step (each updated once a head, in head order) within TOL."""
    np.testing.assert_allclose(run["ploss"], run["jloss"], rtol=1e-5)
    assert want_stats <= run["stats"]
    for k in run["stats"]:
        assert _rel_l2(run["pstate"][k].numpy(), run["jstate"][k].numpy()) <= TOL, k


def assert_sep_gradients(run, no_grad, tol=TOL, exact=()):
    """Every parameter's first-step gradient (Adam's first moment) within
    `tol` of JAX's (those whose names start with one of `exact` within TOL);
    the `no_grad` biases, which a BatchNorm removes next, held to rounding
    noise (<= 1e-6 of the gradient's norm) on both sides."""
    want, got = run["jmu"], run["pmu"]
    assert set(want) == set(got) == {k for k in run["pstate"] if k not in run["stats"]}
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in want.values()))
    for k, v in want.items():
        if k.removeprefix("encoder.") in no_grad:
            assert max(float(v.abs().max()), float(got[k].abs().max())) <= 1e-6 * total, k
            continue
        err = _rel(got[k].numpy(), v.numpy())
        assert err <= (TOL if k.startswith(exact) else tol), (k, err)
    assert sum(k.removeprefix("encoder.") in no_grad for k in want) == len(no_grad)


def assert_sep_parameters(run, no_grad):
    """Every parameter after the update within TOL of JAX's, but the
    `no_grad` biases: their rounding-noise gradients take Adam steps of the
    lr's size and either sign, so these are held within two steps of
    JAX's."""
    for k in run["jmu"]:
        got, want = run["pstate"][k].numpy(), run["jstate"][k].numpy()
        if k.removeprefix("encoder.") in no_grad:
            assert np.abs(got - want).max() <= 2.0 * LR, k
        else:
            assert _rel_l2(got, want) <= TOL, (k, _rel_l2(got, want))


def _rel(got, want):
    """Relative L2 distance; 0 when both are zero (a ReLU that is off for
    every input gives its parameters no gradient)."""
    return 0.0 if not want.any() and not got.any() else _rel_l2(got, want)


@pytest.fixture(scope="module")
def sep_step():
    return sep_first_step("upernet", JAX_SIDE)


def test_sep_forward_losses_and_batch_stats_match_jax(sep_step):
    """ViT-Adapter + UperNet, one SEP step (``make_pretrain_step``'s three
    train-mode forwards, one a head in head order): each head's
    cross-entropy, and the spatial prior's, the final norms' and UperNet's
    BatchNorm statistics after it."""
    assert_sep_losses_and_stats(sep_step, {
        "encoder.spm.stem.1.running_var", "encoder.norm4.running_mean",
        "seg_decoder.fpn_bottleneck.bn.running_var"})


def test_sep_first_step_gradients_match_jax(sep_step):
    """The whole model's first-step gradients, every parameter within TOL:
    the spatial prior, the injectors and extractors (the sampling nets
    through K8's coordinate derivative), the blocks, up and the final
    norms, UperNet, the three heads."""
    assert_sep_gradients(sep_step, NO_GRAD_UPERNET)
    assert "encoder.interactions.0.injector.attn.sampling_offsets.weight" in sep_step["jmu"]


def test_sep_first_step_parameters_match_jax(sep_step):
    """The parameters after the first layer-decay AdamW update."""
    assert_sep_parameters(sep_step, NO_GRAD_UPERNET)


# ----------------------------------------------------- run_pretrain ----


def test_run_pretrain_vit_adapter_unetpp_end_to_end(tmp_path, caplog):
    """``run_pretrain`` with backbone=vit_adapter_b decoder=unetpp (the
    family's optimizer row: layer decay 0.95 over the encoder's depth) on two
    tmp datasets with a tiny ViT-Adapter + UNet++: 2 iterations, an eval,
    checkpoints, the BatchNorm statistics moved."""
    size = SIZE
    roots = {n: _make_seg_dataset(tmp_path, n, size, n_train=6, n_val=4) for n in ("sota", "sior")}
    ds = lambda split, aug: {n: SegmentationDataset(str(r), str(r / "images"), str(r / "labels"),
                                                    split=split, transform=aug, val_images=4)
                             for n, r in roots.items()}
    over = ["backbone=vit_adapter_b", "decoder=unetpp", "total_iters=2", "eval_interval=2",
            "device=cpu", f"data.root={tmp_path}", "data.datasets=sota,sior",
            f"data.image_size={size}", "data.batch_size=8", "data.num_workers=2",
            "data.val_images=4", "optim.warmup_iters=1", f"ckpt_dir={tmp_path / 'ckpt'}"]
    cfg = apply_optim_defaults(PretrainConfig().override(over), over)
    assert (cfg.optim.lr, cfg.optim.weight_decay, cfg.optim.layer_decay) == (6e-5, 0.01, 0.95)
    model = TinyPort((18, 20), decoder="unetpp")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trn = ds("trn", TrainAugment(size, rng=np.random.default_rng(0)))
    with caplog.at_level(logging.INFO, logger="samrs_tpu_torch.pretrain"):
        state = run_pretrain(cfg, model=model, datasets_trn=trn,
                             datasets_val=ds("val", EvalAugment(size)))
    assert state.step == 2
    scales = {g["lr_scale"] for g in state.optimizer.opt.param_groups}
    assert max(scales) == 1.0 and min(scales) == pytest.approx(0.95 ** 5)
    for f in ("last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"):
        assert os.path.exists(tmp_path / "ckpt" / f), f
    vals = [r.getMessage() for r in caplog.records if r.getMessage().startswith("val[")]
    assert {v.split("]")[0] for v in vals} == {"val[sota", "val[sior"}
    after = model.state_dict()
    for k in ("encoder.norm1.running_mean", "encoder.spm.stem.1.running_var",
              "seg_decoder.final_conv.bn.running_mean"):
        assert not torch.equal(after[k], before[k]), k
    assert all(torch.isfinite(v).all() for v in after.values() if v.is_floating_point())
