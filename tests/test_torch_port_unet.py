"""The UNet and UNet++ decoders in the PyTorch port (samrs_tpu_torch.seg.decoders
unet / unetpp / blocks) vs the JAX package, on CPU in fp32.

The decoders and SCSE run on flax variables whose every leaf is drawn with
numpy, bridged with ``jax_params_to_torch`` and loaded strictly: outputs,
the gradients of a fixed random projection of them, and the BatchNorm
statistics after a train-mode forward.  The resizes against ``jax.image``
and the JAX helpers; ``MultiHeadSegModel`` and ``SegModel`` with
``unet`` / ``unetpp`` against the JAX frameworks (the 3x3 head without
dropout); ``run_finetune`` and ``run_test`` end to end with
``backbone=vit_adapter_b decoder=unet`` (a tiny ViT-Adapter).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from samrs_tpu.seg.decoders import blocks as jax_blocks
from samrs_tpu.seg.decoders.unet import UnetDecoder as JaxUnet
from samrs_tpu.seg.decoders.unetpp import UnetPlusPlusDecoder as JaxUnetPP
from samrs_tpu.seg.frameworks import MultiHeadSegModel as JaxMultiHead
from samrs_tpu.seg.frameworks import SegModel as JaxSegModel
from samrs_tpu_torch.core.config import DataConfig, FinetuneConfig, OptimConfig
from samrs_tpu_torch.seg.backbones.vit_adapter import ViTAdapter
from samrs_tpu_torch.seg.decoders import blocks
from samrs_tpu_torch.seg.decoders.unet import UnetDecoder
from samrs_tpu_torch.seg.decoders.unetpp import UnetPlusPlusDecoder
from samrs_tpu_torch.seg.frameworks import MultiHeadSegModel, SegHead, SegModel
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.train import evaluate
from samrs_tpu_torch.train.finetune import run_finetune
from test_torch_port_finetune import _split_files, _write_isprs
from test_torch_port_seg import _rel_l2, draw_variables
from test_torch_port_vit_adapter import (INTERACTIONS, NO_GRAD, TINY, TOL, _assert_parity, _nchw,
                                         _parity)
from test_torch_port_vit_adapter_train import (assert_sep_gradients, assert_sep_losses_and_stats,
                                               sep_first_step)

ENC_CHANNELS = (8, 12, 16, 20)   # c1..c4
ENC_HW = (16, 8, 4, 2)           # strides 4..32 of a 64^2 image
DEC_CHANNELS = (24, 16, 12, 8)


def _features(seed, B=3):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, 64, 64, 3)).astype(np.float32)
    return [img] + [rng.normal(size=(B, hw, hw, c)).astype(np.float32)
                    for c, hw in zip(ENC_CHANNELS, ENC_HW)]


def _port_features(feats):
    return [torch.from_numpy(feats[0])] + [torch.from_numpy(f).permute(0, 3, 1, 2)
                                           for f in feats[1:]]


def test_scse_matches_flax():
    """Channel SE (mean, 1x1 bottleneck, sigmoid) plus spatial SE (1x1 to one
    channel, sigmoid), reduction 16."""
    x = np.random.default_rng(1).normal(size=(2, 6, 6, 40)).astype(np.float32)
    res = _parity(jax_blocks.SCSEModule(), (jnp.asarray(x),), blocks.SCSEModule(40),
                  lambda m, _: [m(torch.from_numpy(x).permute(0, 3, 1, 2))],
                  ["seg_decoder", "block0", "attention1"], "seg_decoder.block0.attention1.", 2,
                  jout=lambda o: _nchw([o]))
    _assert_parity(res)


@pytest.mark.parametrize("hw,out", [((8, 8), (5, 5)), ((8, 6), (16, 12)), ((7, 9), (3, 4))])
def test_resizes_match_jax(hw, out):
    """The decoders' skip and final resizes (``resize_bilinear``) equal the
    JAX helper ``resize_bilinear_nhwc`` as the decoders call it (torch's
    bilinear, no antialiasing, the downscales included);
    ``upsample_nearest_2x`` equal to JAX's."""
    x = np.random.default_rng(hw[0]).normal(size=(2, *hw, 5)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = jax_blocks.resize_bilinear_nhwc(jnp.asarray(x), out)
    got = blocks.resize_bilinear(xt, out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(blocks.upsample_nearest_2x(xt).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_blocks.upsample_nearest_2x(jnp.asarray(x))))


@pytest.mark.parametrize("attention", ["none", "scse"])
def test_unet_decoder_matches_flax(attention):
    """UNet over [img, c1..c4]: four blocks (2x nearest, skip resize and
    concat, SCSE under ``scse``, two ConvBNReLU), the last without a skip,
    and the final 2x bilinear; outputs, gradients and the eight BatchNorms'
    statistics."""
    feats = _features(3)
    res = _parity(JaxUnet(DEC_CHANNELS, attention_type=attention),
                  ([jnp.asarray(f) for f in feats], True),
                  UnetDecoder(ENC_CHANNELS, DEC_CHANNELS, attention_type=attention),
                  lambda m, _: [m(_port_features(feats))], ["seg_decoder"], "seg_decoder.", 4,
                  jout=lambda o: _nchw([o]))
    _assert_parity(res, n_stats=16)
    if attention == "scse":
        assert "block3.attention2.sse_conv.weight" in res["grad"]
        assert "block3.attention1.cse_fc1.weight" not in res["grad"]  # no skip: no SCSE before


def test_unetpp_decoder_matches_flax():
    """UNet++'s nested nodes X[l][j] over c1..c4, the extra stride-2
    ``final_conv`` and the final 2x bilinear; outputs, gradients and the 13
    BatchNorms' statistics."""
    feats = _features(5)
    res = _parity(JaxUnetPP(DEC_CHANNELS), ([jnp.asarray(f) for f in feats], True),
                  UnetPlusPlusDecoder(ENC_CHANNELS, DEC_CHANNELS),
                  lambda m, _: [m(_port_features(feats))], ["seg_decoder"], "seg_decoder.", 6,
                  jout=lambda o: _nchw([o]))
    _assert_parity(res, n_stats=2 * 13)
    assert "node_0_3_conv2.conv.weight" in res["grad"] and "final_conv.bn.weight" in res["grad"]


def test_upsample_split_gives_the_same_map():
    """``forward(upsample=False)`` then ``upsample`` (how the frameworks
    recompute the last 2x and the head in the backward) equals the full
    forward."""
    feats = _port_features(_features(7))
    for dec in (UnetDecoder(ENC_CHANNELS, DEC_CHANNELS), UnetPlusPlusDecoder(ENC_CHANNELS,
                                                                             DEC_CHANNELS)):
        dec.eval()
        with torch.no_grad():
            assert torch.equal(dec.upsample(dec(feats, upsample=False)), dec(feats))


def _framework_parity(jm, pm, jinit, jcall, pcall, seed):
    """Eval-mode logits of a JAX framework and the port's on the same drawn
    variables (bridged, loaded strictly)."""
    x = np.random.default_rng(seed).normal(size=(2, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            *jinit(jnp.zeros((1, 32, 32, 3)))))
    jvars = draw_variables(shapes, seed)
    pm.load_state_dict(jax_params_to_torch(jvars["params"], jvars["batch_stats"]), strict=True)
    pm.eval()
    want = jax.jit(lambda v, a: jm.apply(v, *jcall(a)))(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = pcall(pm, torch.from_numpy(x))
    return got, want


@pytest.mark.parametrize("decoder", ["unet", "unetpp"])
def test_frameworks_give_unet_decoders_a_3x3_head(decoder):
    """Every head after a UNet-style decoder is a 3x3 conv with no dropout
    (models.py:14-21); UperNet keeps dropout 0.1 and a 1x1 conv."""
    with torch.device("meta"):
        models = [MultiHeadSegModel("vit_b", decoder, (18, 20, 37), image_size=32),
                  SegModel("vit_b", decoder, 6, image_size=32)]
        upernet = SegModel("vit_b", "upernet", 6, image_size=32)
    for head in [*models[0].heads, models[1].head]:
        assert head.conv.kernel_size == (3, 3) and head.dropout.rate == 0.0
        assert head.conv.in_channels == 64
    assert upernet.head.conv.kernel_size == (1, 1) and upernet.head.dropout.rate == 0.1


def test_multihead_model_with_unet_matches_jax():
    """``MultiHeadSegModel`` (SOTA / SIOR / FAST heads) with vit_b at full
    width and ``unet``: the bridge loads strictly and the eval-mode logits of
    the heads that get a batch agree with the JAX framework's."""
    pm = MultiHeadSegModel("vit_b", "unet", (18, 20, 37), image_size=32)
    got, want = _framework_parity(
        JaxMultiHead(backbone="vit_b", decoder="unet", image_size=32), pm,
        lambda a: ([a, a, a],), lambda a: ([a, None, a],), lambda m, a: m([a, None, a]), 31)
    assert got[1] is None and want[1] is None
    for i in (0, 2):
        assert _rel_l2(got[i].numpy(), np.asarray(want[i])) <= TOL, i


def test_seg_model_with_unetpp_matches_jax():
    """``SegModel`` with vit_b at full width and ``unetpp``: strict bridge,
    eval-mode logits equal to the JAX framework's."""
    sm = SegModel("vit_b", "unetpp", 6, image_size=32)
    got, want = _framework_parity(JaxSegModel(backbone="vit_b", decoder="unetpp", image_size=32),
                                  sm, lambda a: (a,), lambda a: (a,), lambda m, a: m(a), 32)
    assert got.shape == (2, 32, 32, 6)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= TOL


# Behind a UNet-style decoder the whole model's fp32 gradient sits on many more ReLU /
# BatchNorm kinks that rounding decides (full-resolution decoder maps, BatchNorms over
# 4x4 maps): JAX's own gradients at the images scaled by 1 and by 1 + 1e-7 are up to
# 1.8e-2 apart, and no one scaling brings the port's within TOL of them everywhere (the
# worst, 3.7e-2, in a UNet++ node's BatchNorm).  So the step's gradients are held to
# GROSS, which a wrong term in a module or its wiring exceeds, and the heads, after the
# last ReLU, to TOL.  The strict whole-model check is UperNet's
# (test_torch_port_vit_adapter_train.py).
GROSS = 5e-2


@pytest.fixture(scope="module", params=["unet", "unetpp"])
def sep_step_unet(request):
    """One SEP step of a tiny ViT-Adapter + UNet / UNet++ with the 3x3
    heads, through ``make_pretrain_step`` and the port's ``pretrain_step``
    from the same state; no clipping (clip 1e6), so that Adam's first
    moment is 0.1 x the raw gradient and the heads' are not scaled by the
    rest's norm."""
    return request.param, sep_first_step(request.param, grad_clip=1e6)


def test_sep_step_with_unet_decoders_losses_and_batch_stats_match_jax(sep_step_unet):
    """Each head's cross-entropy and every BatchNorm's statistics after the
    step (the spatial prior's, norm1..norm4 and the decoder's, each updated
    once a head in head order)."""
    decoder, run = sep_step_unet
    last = "block3.conv2" if decoder == "unet" else "final_conv"
    assert_sep_losses_and_stats(run, {"encoder.spm.stem.1.running_var",
                                      "encoder.norm1.running_mean",
                                      f"seg_decoder.{last}.bn.running_var"})


def test_sep_step_with_unet_decoders_gradients_match_jax(sep_step_unet):
    """The first-step gradients: the three 3x3 heads within TOL, every
    other parameter within GROSS, the NO_GRAD biases noise on both sides."""
    _, run = sep_step_unet
    assert_sep_gradients(run, NO_GRAD, tol=GROSS, exact=("heads.",))
    assert run["jmu"]["heads.0.conv.weight"].shape[-2:] == (3, 3)


class TinyAdapterUnet(SegModel):
    """The port's SegModel with a tiny ViT-Adapter (2 interactions, 32 wide)
    and a small UNet, without drop-path."""

    def __init__(self, size):
        nn.Module.__init__(self)
        self.backbone, self.decoder, self.num_classes, self.image_size = \
            "vit_adapter_b", "unet", 6, size
        self.use_kernels = True
        self.encoder = ViTAdapter(**dict(TINY, img_size=size, interaction_indexes=INTERACTIONS[2]))
        self.seg_decoder = UnetDecoder(self.encoder.out_channels[1:], DEC_CHANNELS)
        self.head = SegHead(DEC_CHANNELS[-1], 6, kernel=3)


def test_finetune_and_evaluate_with_unet_end_to_end(tmp_path, caplog):
    """``run_finetune`` with ``backbone=vit_adapter_b decoder=unet`` (the
    layer ids over a tiny ViT-Adapter + UNet) for one epoch on a
    tmp Potsdam tree, then ``run_test`` (the evaluate CLI's loop: crop grid,
    flip TTA) on two test images: the epoch line, the checkpoints, one gray
    and one colour PNG a test image."""
    S = 32
    rng = np.random.default_rng(0)
    root = tmp_path / "potsdam"
    names = [f"p{i}" for i in range(6)]
    _write_isprs(root, names, (S + 6, S + 10), rng)
    _split_files(root, names, 4)
    cfg = FinetuneConfig(backbone="vit_adapter_b", decoder="unet", epochs=1, image_size=S,
                         batch_size=2, seed=0, device="cpu",
                         data=DataConfig(root=str(tmp_path), num_workers=2, val_images=2),
                         optim=OptimConfig(lr=1e-3, warmup_iters=1), ckpt_dir=str(tmp_path / "ft"))
    model = TinyAdapterUnet(S)
    with caplog.at_level(logging.INFO, logger="samrs_tpu_torch.finetune"):
        state = run_finetune(cfg, model=model)
    assert state.step == 2
    # the config's layer decay (JAX's finetune keeps cfg.optim's) over the encoder's 4 blocks
    scales = {g["lr_scale"] for g in state.optimizer.opt.param_groups}
    assert max(scales) == 1.0 and min(scales) == pytest.approx(cfg.optim.layer_decay ** 5)
    epochs = [r.getMessage() for r in caplog.records if r.getMessage().startswith("epoch 1/1")]
    assert len(epochs) == 1 and 0.0 <= float(epochs[0].split("mIoU ")[1].split()[0]) <= 1.0
    saved = torch.load(tmp_path / "ft" / "last.pt", weights_only=True)
    assert saved["step"] == 2 and saved["model"]["head.conv.weight"].shape == (6, 8, 3, 3)
    assert "seg_decoder.block0.conv1.bn.running_mean" in saved["model"]
    data = [(rng.integers(0, 256, (S + 6, S + 10, 3), dtype=np.uint8),
             rng.integers(0, 6, (S + 6, S + 10)).astype(np.int32)) for _ in range(2)]
    out = tmp_path / "test_out"
    scores = evaluate.run_test(model, data, 6, S, save_dir=str(out),
                               palette=evaluate.dataset_palette("potsdam"))
    assert 0.0 <= scores["miou"] <= 1.0
    for sub in ("gray", "color"):
        files = sorted(os.listdir(out / sub))
        assert len(files) == 2, (sub, files)
        with Image.open(out / sub / files[0]) as im:
            assert im.size == (S + 10, S + 6)
