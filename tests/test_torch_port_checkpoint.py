"""Torch backbone checkpoints (``pretrained=``) in the PyTorch port
(samrs_tpu_torch.seg.port.load_backbone_checkpoint) vs the JAX package's
loader, on CPU in fp32.

For each of the seven families, tiny: a seeded ``.pth`` in the reference
layout written here (the port encoder's keys, which are the reference's,
under ``module.backbone.``; MAE extras; the reference's keys the port has no
tensor for, BatchNorm step counters among them; one key of the wrong shape;
for the ViTs a pos-embed with a cls slot on a grid larger and one smaller
than the model's).  JAX ``load_backbone_checkpoint`` loads it into a drawn
JAX init, ``jax_params_to_torch`` carries the result over, and it must equal
the port's loader on the same file over the same init: every parameter and
BatchNorm statistic equal (the resized pos-embed within 1e-6), the same
loaded and skipped key sets, the same report line, and the encoders'
eval outputs within 1e-5.
"""

import io
import logging
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.seg import port as jport
from samrs_tpu.seg.backbones import internimage as j_ii
from samrs_tpu.seg.backbones import resnet as j_rn
from samrs_tpu.seg.backbones import rvsa as j_rvsa
from samrs_tpu.seg.backbones import swin as j_swin
from samrs_tpu.seg.backbones import vit as j_vit
from samrs_tpu.seg.backbones import vit_adapter as j_va
from samrs_tpu.seg.backbones import vitae as j_vitae
from samrs_tpu_torch.nn.layers import jax_bicubic_weights
from samrs_tpu_torch.seg.backbones import internimage, resnet, rvsa, swin, vit, vit_adapter, vitae
from samrs_tpu_torch.seg.port import (interpolate_pos_embed, jax_params_to_torch,
                                      load_backbone_checkpoint)
from test_torch_port_internimage import TINY as II_TINY
from test_torch_port_resnet import TINY as RESNET_TINY
from test_torch_port_seg import TINY_RVSA, _rel_l2, draw_variables
from test_torch_port_swin import TINY as SWIN_TINY
from test_torch_port_vit_adapter import TINY as ADAPTER_TINY
from test_torch_port_vitae import TINY as VITAE_TINY

OUT_TOL = 1e-5   # encoder outputs, fp32 both sides
# the resized pos-embed: the port's within POS_TOL of jax.image's bicubic weights applied in
# float64; JAX's own fp32 contraction of the same weights lands up to ~7e-6 from that (6.5e-6
# at 14^2 -> 16^2 on unit normals), so the two packages are held within JAX_POS_TOL
POS_TOL = 1e-6
JAX_POS_TOL = 1e-5
RVSA = dict(TINY_RVSA, use_abs_pos_emb=True)
ADAPTER = dict(ADAPTER_TINY, interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)))
# family -> (image size, JAX encoder, port encoder, the reference's keys the port holds no
# tensor for (name -> shape), the key given the wrong shape)
FAMILIES = {
    "vit_b_rvsa": (80, lambda: j_rvsa.ViTRVSA(img_size=80, **RVSA),
                   lambda: rvsa.ViTRVSA(img_size=80, **RVSA),
                   {"blocks.0.attn.relative_position_index": (49, 49)}, "blocks.1.mlp.fc1.weight"),
    "vit_b": (64, lambda: j_vit.ViTSeg(img_size=64, embed_dim=32, depth=2, num_heads=2),
              lambda: vit.ViTSeg(img_size=64, embed_dim=32, depth=2, num_heads=2),
              {"head.weight": (10, 32)}, "patch_embed.proj.bias"),
    "swin_t": (64, lambda: j_swin.Swin(**SWIN_TINY), lambda: swin.Swin(**SWIN_TINY),
               {"layers.0.blocks.0.attn.relative_position_index": (49, 49),
                "layers.0.blocks.1.attn_mask": (4, 49, 49), "norm.weight": (16,)},
               "layers.1.blocks.0.mlp.fc2.weight"),
    "resnet50": (64, lambda: j_rn.ResNet(**RESNET_TINY), lambda: resnet.ResNet(**RESNET_TINY),
                 {"bn1.num_batches_tracked": (), "layer1.0.bn2.num_batches_tracked": (),
                  "layer2.0.downsample.1.num_batches_tracked": (), "fc.weight": (10, 2048),
                  "fc.bias": (10,)}, "layer1.1.conv2.weight"),
    "vitaev2_s": (64, lambda: j_vitae.ViTAEv2(**VITAE_TINY), lambda: vitae.ViTAEv2(**VITAE_TINY),
                  {"layers.0.RC.PCM.1.num_batches_tracked": (),
                   "layers.1.NC.0.attn.relative_position_bias_table": (9, 2),
                   "norm3.weight": (32,)}, "layers.2.NC.0.mlp.fc1.weight"),
    "internimage_t": (64, lambda: j_ii.InternImage(**II_TINY),
                      lambda: internimage.InternImage(**II_TINY),
                      {"conv_head.0.weight": (32, 128, 1, 1), "head.weight": (10, 32)},
                      "levels.2.blocks.1.dcn.offset.weight"),
    "vit_adapter_b": (64, lambda: j_va.ViTAdapter(**ADAPTER),
                      lambda: vit_adapter.ViTAdapter(**ADAPTER),
                      {"spm.stem.1.num_batches_tracked": (), "norm2.num_batches_tracked": (),
                       "fc_norm.weight": (32,), "head.weight": (10, 32)},
                      "interactions.1.extractor.ffn.fc1.weight"),
}
VIT_FAMILIES = ("vit_b_rvsa", "vit_b", "vit_adapter_b")
CASES = [(f, d) for f in FAMILIES for d in ((2, -1) if f in VIT_FAMILIES else (0,))]


def _jax_init(family):
    size, jm_fn = FAMILIES[family][:2]
    jm = jm_fn()
    x = jnp.zeros((1, size, size, 3))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "dropout": jax.random.PRNGKey(1)}, x, False))
    v = draw_variables(shapes, 5)
    return jm, v["params"], v.get("batch_stats", {})


def write_reference_pth(path, encoder, extras, wrong, pos_delta, cls_slot=1, seed=0):
    """A seeded state dict in the reference layout: the encoder's keys under
    ``module.backbone.`` (BatchNorm variances positive), `extras`, MAE's
    ``mask_token`` / ``cls_token`` / decoder, `wrong` one row too long, and
    for a ViT a pos-embed on the grid `pos_delta` larger, with `cls_slot`
    cls tokens before it."""
    rng = np.random.default_rng(seed)
    sd = {}
    shapes = {k: tuple(v.shape) for k, v in encoder.state_dict().items()}
    shapes.update(extras)
    shapes.update({"mask_token": (1, 1, 8), "cls_token": (1, 1, 8),
                   "decoder_embed.weight": (8, 8), "decoder_pos_embed": (1, 5, 8)})
    shapes[wrong] = (shapes[wrong][0] + 1,) + shapes[wrong][1:]
    if "pos_embed" in shapes:  # the adapter's own checkpoints hold no cls slot
        g = int(round(shapes["pos_embed"][1] ** 0.5)) + pos_delta
        shapes["pos_embed"] = (1, g * g + cls_slot, shapes["pos_embed"][2])
    for k, s in shapes.items():
        v = rng.normal(size=s)
        if k.endswith("num_batches_tracked"):
            v = 7
        elif k.endswith("running_var"):
            v = 1.0 + 0.1 * np.abs(v)
        elif k.endswith("weight") and len(s) >= 2:
            v = v * np.prod(s[1:]) ** -0.5  # fan-in scale: finite, moderate activations
        elif k.endswith(("weight", "gamma1", "gamma2")):
            v = 1.0 + 0.1 * v
        elif "pos_embed" not in k:
            v = 0.1 * v
        dtype = np.int64 if k.endswith("num_batches_tracked") else np.float32
        sd["module.backbone." + k] = torch.as_tensor(np.asarray(v, dtype))
    torch.save({"model": sd}, path)
    return sd


def _jax_load(path, params, stats):
    """JAX's loader on `path`: (params, stats, loaded, skipped, printed line)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = jport.load_backbone_checkpoint(path, params, stats or None)
    p, s = out if stats else (out, {})
    # the family rule's own lists (load_backbone_checkpoint prints their sizes only)
    sd = jport._strip_prefixes({k: v.numpy() for k, v in
                                torch.load(path, weights_only=True)["model"].items()})
    fam = jport.detect_backbone_family(sd)
    if fam in ("resnet", "vitae", "vit_adapter"):
        loader = {"resnet": jport.load_torch_resnet_backbone, "vitae": jport.load_torch_vitae_backbone,
                  "vit_adapter": jport.load_torch_vit_adapter_backbone}[fam]
        _, _, loaded, skipped = loader(sd, params, stats)
    else:
        loader = {"internimage": jport.load_torch_internimage_backbone,
                  "swin": jport.load_torch_swin_backbone, "vit": jport.load_torch_vit_backbone}[fam]
        _, loaded, skipped = loader(sd, params)
    return p, s, loaded, skipped, buf.getvalue().strip()


def _resize64(pos, tokens):
    """(1, g*g, D) -> (1, tokens, D): jax.image's bicubic weights (the port's
    copy, held to jax.image.resize in test_torch_port_finetune.py) applied in
    float64."""
    g0, g1 = int(round(pos.shape[1] ** 0.5)), int(round(tokens ** 0.5))
    w = jax_bicubic_weights(g0, g1).astype(np.float64)
    grid = pos.reshape(1, g0, g0, -1).astype(np.float64)
    return np.einsum("bhwc,hy,wx->byxc", grid, w, w).reshape(1, g1 * g1, -1)


def _as_jax(o, x):
    """A port output in the JAX one's layout: the maps are NCHW, the image
    (a ViT's first output) NHWC."""
    return o if o is x or (o.shape == x.shape and torch.equal(o, x)) else o.permute(0, 2, 3, 1)


@pytest.fixture(scope="module", params=CASES, ids=[f"{f}-pos{d:+d}" for f, d in CASES])
def loaded(request, tmp_path_factory):
    family, delta = request.param
    size, _, pm_fn, extras, wrong = FAMILIES[family]
    jm, params, stats = _jax_init(family)
    encoder = pm_fn().eval()
    init = jax_params_to_torch({"encoder": params}, {"encoder": stats} if stats else None)
    encoder.load_state_dict({k[len("encoder."):]: v for k, v in init.items()}, strict=True)
    path = str(tmp_path_factory.mktemp("pth") / f"{family}.pth")
    write_reference_pth(path, encoder, extras, wrong, delta, int(family != "vit_adapter_b"))
    jp, js, jloaded, jskipped, line = _jax_load(path, params, stats)
    logs = []
    handler = logging.Handler()
    handler.emit = lambda r: logs.append(r.getMessage())
    log = logging.getLogger("samrs_tpu_torch.seg.port")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        got = load_backbone_checkpoint(path, encoder)
    finally:
        log.removeHandler(handler)
    want = {k[len("encoder."):]: v for k, v in jax_params_to_torch(
        {"encoder": jp}, {"encoder": js} if js else None).items()}
    return dict(family=family, jm=jm, jvars={"params": jp, "batch_stats": js}, encoder=encoder,
                want=want, got=got, jloaded=jloaded, jskipped=jskipped, line=line, logs=logs,
                size=size, path=path)


def test_loaded_and_skipped_sets_match_jax(loaded):
    got = loaded["got"]
    assert set(got.loaded) == set(loaded["jloaded"])
    assert set(got.skipped) == set(loaded["jskipped"])
    assert len(got.loaded) == len(loaded["jloaded"]) and len(got.skipped) == len(loaded["jskipped"])
    assert loaded["logs"] == [loaded["line"]]
    assert FAMILIES[loaded["family"]][4] in got.skipped  # the wrong-shaped key
    assert "decoder_embed.weight" in got.skipped


def test_encoder_state_matches_jax(loaded):
    """Every parameter and BatchNorm statistic after the load, the pos-embed
    (resized on both sides) within POS_TOL, the rest equal."""
    sd = loaded["encoder"].state_dict()
    assert set(sd) == set(loaded["want"])
    for k, w in loaded["want"].items():
        g = sd[k]
        if k == "pos_embed" and "pos_embed" in loaded["got"].loaded:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=JAX_POS_TOL)
            pos = torch.load(loaded["path"], weights_only=True)["model"]["module.backbone.pos_embed"]
            grid = pos.numpy()[:, pos.shape[1] - int(round(pos.shape[1] ** 0.5)) ** 2:]
            np.testing.assert_allclose(g.numpy(), _resize64(grid, g.shape[1]), rtol=0,
                                       atol=POS_TOL)
        else:
            assert torch.equal(g, w), k
    ckpt = torch.load(loaded["path"], weights_only=True)["model"]
    moved = [k for k in loaded["got"].loaded if k in sd and k != "pos_embed"
             and torch.equal(sd[k], ckpt["module.backbone." + k])]
    assert len(moved) == sum(k in sd and k != "pos_embed" for k in loaded["got"].loaded)


def test_encoder_outputs_match_jax(loaded):
    """Eval outputs of the loaded encoders on one seeded image."""
    size = loaded["size"]
    x = np.random.default_rng(3).normal(size=(1, size, size, 3)).astype(np.float32)
    jm = loaded["jm"]
    jouts = [np.asarray(o) for o in jax.jit(lambda v, a: jm.apply(v, a, False))(
        loaded["jvars"], jnp.asarray(x))]
    with torch.no_grad():
        xt = torch.from_numpy(x)
        pouts = loaded["encoder"](xt)
    for j, o in zip(jouts, pouts, strict=True):
        p = _as_jax(o, xt).numpy()
        assert j.shape == p.shape
        assert _rel_l2(p, j) <= OUT_TOL


def test_interpolate_pos_embed_matches_jax():
    rng = np.random.default_rng(1)
    for n, target, cls in ((197, 196, True), (50, 16, True), (10, 49, True), (64, 16, False),
                           (196, 196, True)):
        pos = rng.normal(size=(1, n, 8)).astype(np.float32)
        want = jport.interpolate_pos_embed(pos, target, has_cls=cls)
        got = interpolate_pos_embed(torch.from_numpy(pos), target, has_cls=cls).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_POS_TOL)
        grid = pos[:, n - int(round(n ** 0.5)) ** 2:]  # the cls slot off where there is one
        np.testing.assert_allclose(got, _resize64(grid, target), rtol=0, atol=POS_TOL)
    with pytest.raises(ValueError):
        interpolate_pos_embed(torch.zeros(1, 7, 4), 16, has_cls=False)


class _Opaque:
    """Not a tensor: weights_only=True refuses to unpickle it."""


def test_pickled_checkpoint_needs_allow_pickle(tmp_path):
    enc = swin.Swin(**SWIN_TINY)
    sd = {k: v.clone() + 1.0 for k, v in enc.state_dict().items()}
    path = str(tmp_path / "pickled.pth")
    torch.save({"model": sd, "meta": _Opaque()}, path)
    with pytest.raises(RuntimeError, match="allow_pickle=True"):
        load_backbone_checkpoint(path, enc)
    with pytest.warns(UserWarning, match="weights_only=False"):
        got = load_backbone_checkpoint(path, enc, allow_pickle=True)
    assert got.family == "swin" and len(got.loaded) == len(sd)
    assert all(torch.equal(enc.state_dict()[k], v) for k, v in sd.items())


def test_batchnorm_family_needs_batchnorm_encoder(tmp_path):
    path = str(tmp_path / "resnet.pth")
    torch.save(resnet.ResNet(**RESNET_TINY).state_dict(), path)
    with pytest.raises(ValueError, match="BatchNorm"):
        load_backbone_checkpoint(path, swin.Swin(**SWIN_TINY))
