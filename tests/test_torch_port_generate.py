"""The port's generate slice (samrs_tpu_torch) vs the JAX package, on CPU in fp32.

The fused two-way transformer and mask decoder (K4/K5/K6 plain versions),
the predictor's device-resident decode and bit packing, the host modules of
the label generator (loaders, geometry, RLE, constants) and the generator
itself end to end against ``samrs_tpu.generate.semantic``.  A tiny SAM gets
its variable tree from the JAX model with every leaf drawn with numpy and is
bridged into the port with ``jax_params_to_torch``; inputs are made with
numpy from seeds and handed to both sides.
"""

import inspect
import os
import pickle

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from samrs_tpu.core.config import GenerateConfig as JaxGenerateConfig
from samrs_tpu.core.config import sam_config as jax_sam_config
from samrs_tpu.data import loaders as jax_loaders
from samrs_tpu.data import mapping as jax_mapping
from samrs_tpu.data.rle import rle_decode as jax_rle_decode
from samrs_tpu.data.rle import rle_encode as jax_rle_encode
from samrs_tpu.generate.semantic import SemanticGenerator as JaxGenerator
from samrs_tpu.generate.semantic import generate_semantic as jax_generate_semantic
from samrs_tpu.geometry.obb import obb2poly as jax_obb2poly
from samrs_tpu.geometry.obb import poly_to_hbb as jax_poly_to_hbb
from samrs_tpu.sam import Sam as JaxSam
from samrs_tpu.sam.build import init_sam_variables
from samrs_tpu.sam.predictor import SamPredictor as JaxPredictor
from samrs_tpu.sam.transformer import TwoWayTransformer as JaxTwoWayTransformer
from samrs_tpu_torch.core.config import GenerateConfig, sam_config
from samrs_tpu_torch.data import loaders, mapping
from samrs_tpu_torch.data.rle import rle_decode, rle_encode
from samrs_tpu_torch.generate.semantic import SemanticGenerator, generate_semantic
from samrs_tpu_torch.geometry.obb import obb2poly, poly_to_hbb
from samrs_tpu_torch.sam import SamPredictor, build_sam
from samrs_tpu_torch.sam.port import jax_params_to_torch
from samrs_tpu_torch.sam.predictor import packbits2d, unpackbits2d

TINY = dict(image_size=96, patch_size=16, window_size=4, encoder_embed_dim=32,
            encoder_depth=3, encoder_num_heads=2, encoder_global_attn_indexes=(2,),
            prompt_embed_dim=32, mask_in_chans=8, decoder_mlp_dim=64, decoder_num_heads=2,
            iou_head_hidden_dim=32)
TOL = 1e-4  # fp32 both sides; only summation order differs

DIOR_XML = """<annotation>
  <object><name>ship</name>
    <bndbox><xmin>5</xmin><ymin>5</ymin><xmax>30</xmax><ymax>25</ymax></bndbox>
  </object>
  <object><name>harbor</name>
    <bndbox><xmin>40</xmin><ymin>20</ymin><xmax>75</xmax><ymax>55</ymax></bndbox>
  </object>
</annotation>"""

HRSC_XML = """<HRSC_Image><HRSC_Objects>
  <HRSC_Object>
    <box_xmin>10</box_xmin><box_ymin>10</box_ymin><box_xmax>40</box_xmax><box_ymax>30</box_ymax>
    <mbox_cx>25</mbox_cx><mbox_cy>20</mbox_cy><mbox_w>30</mbox_w><mbox_h>16</mbox_h>
    <mbox_ang>0.3</mbox_ang><seg_color>200,30,30</seg_color>
  </HRSC_Object>
  <HRSC_Object>
    <box_xmin>45</box_xmin><box_ymin>35</box_ymin><box_xmax>75</box_xmax><box_ymax>55</box_ymax>
    <mbox_cx>60</mbox_cx><mbox_cy>45</mbox_cy><mbox_w>28</mbox_w><mbox_h>14</mbox_h>
    <mbox_ang>-0.2</mbox_ang><seg_color>30,200</seg_color>
  </HRSC_Object>
</HRSC_Objects></HRSC_Image>"""

# FAIR1M after XML -> DOTA txt: 8 polygon coordinates, class name, class index
FAIR1M_TXT = """12.0 8.0 38.0 14.0 33.0 30.0 8.0 24.0 Small-Car 29
50.0 30.0 74.0 36.5 70.0 55.0 45.5 47.0 Bus 12
20.5 40.0 30.0 36.0 36.0 52.0 26.0 57.0 Van 35
"""


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    """State fp32 for the port's matmuls and convs (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _random_variables(jmodel, seed):
    """The JAX model's variable tree (from a trace, no compile) with every
    leaf drawn with numpy, so no zero-initialised parameter hides a bug."""
    shapes = jax.eval_shape(lambda: init_sam_variables(jmodel, seed=0))
    flat = flax.traverse_util.flatten_dict(shapes)
    rng = np.random.default_rng(seed)
    for k, s in sorted(flat.items()):
        v = rng.normal(size=s.shape)
        if k[-1] == "scale":
            v = 1.0 + 0.1 * v
        elif k[-1] == "kernel":
            v = v * np.prod(s.shape[:-1]) ** -0.5
        else:
            v = 0.1 * v
        flat[k] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model with the package's default decoder, its variables as numpy,
    the port model on the CPU)."""
    jmodel = JaxSam(jax_sam_config("vit_b", **TINY, compute_dtype="float32"))
    assert jmodel.cfg.twoway_impl == "fused" and jmodel.cfg.upscale_impl == "fused"
    jvars = _random_variables(jmodel, seed=11)
    model = build_sam("vit_b", device="cpu", **TINY)
    model.load_state_dict(jax_params_to_torch(jvars, sam_config("vit_b", **TINY)), strict=True)
    return jmodel, jvars, model


def test_build_sam_runs_on_the_card_by_default():
    assert inspect.signature(build_sam).parameters["device"].default == "cuda"
    assert GenerateConfig().device == "cuda"


def test_decoder_parameter_tree_is_impl_agnostic():
    """The JAX package's fused and xla decoders declare one parameter tree,
    and the bridge maps it onto the port's state dict key for key and shape."""
    trees = {}
    for impl in ("fused", "xla"):
        m = JaxSam(jax_sam_config("vit_b", **TINY, compute_dtype="float32",
                                  twoway_impl=impl, upscale_impl=impl))
        shapes = jax.eval_shape(lambda m=m: init_sam_variables(m, seed=0))
        trees[impl] = {k: v.shape for k, v in flax.traverse_util.flatten_dict(shapes).items()}
    assert trees["fused"] == trees["xla"]
    model = build_sam("vit_b", device="cpu", **TINY)
    zeros = flax.traverse_util.unflatten_dict(
        {k: np.zeros(s, np.float32) for k, s in trees["fused"].items()})
    bridged = jax_params_to_torch(zeros, sam_config("vit_b", **TINY))
    assert {k: tuple(v.shape) for k, v in bridged.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("impl", ["fused_test", "xla"])
def test_twoway_transformer_matches_jax(tiny, impl):
    """The port's fused composition (K4/K5 plain versions, fp32) against the
    JAX fused path with oracle kernels and against the module path; the
    image side enters at batch 1 for 3 prompts, as a box decode's does."""
    _, jvars, model = tiny
    rng = np.random.default_rng(3)
    c = TINY["prompt_embed_dim"]
    img = rng.normal(size=(1, 6, 6, c)).astype(np.float32)
    pe = rng.normal(size=(6, 6, c)).astype(np.float32)
    pts = rng.normal(size=(3, 7, c)).astype(np.float32)
    jt = JaxTwoWayTransformer(depth=2, embedding_dim=c, num_heads=TINY["decoder_num_heads"],
                              mlp_dim=TINY["decoder_mlp_dim"], impl=impl)
    tvars = {"params": jvars["params"]["mask_decoder"]["transformer"]}
    q_want, k_want = jt.apply(tvars, jnp.asarray(img), jnp.asarray(pe), jnp.asarray(pts))
    with torch.no_grad():
        q_got, k_got = model.mask_decoder.transformer(
            torch.from_numpy(img), torch.from_numpy(pe), torch.from_numpy(pts))
    np.testing.assert_allclose(q_got.numpy(), np.asarray(q_want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(k_got.numpy(), np.asarray(k_want).reshape(k_got.shape),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_twoway_transformer_many_tokens_matches_jax(tiny, impl):
    """21 tokens (5 output tokens and 16 point prompts): the port's K5 takes
    two blocks of 16 token slots; the JAX package keeps its XLA composition
    beyond 16 tokens whatever the impl."""
    _, jvars, model = tiny
    rng = np.random.default_rng(5)
    c = TINY["prompt_embed_dim"]
    img = rng.normal(size=(1, 6, 6, c)).astype(np.float32)
    pe = rng.normal(size=(6, 6, c)).astype(np.float32)
    pts = rng.normal(size=(2, 21, c)).astype(np.float32)
    jt = JaxTwoWayTransformer(depth=2, embedding_dim=c, num_heads=TINY["decoder_num_heads"],
                              mlp_dim=TINY["decoder_mlp_dim"], impl=impl)
    tvars = {"params": jvars["params"]["mask_decoder"]["transformer"]}
    q_want, k_want = jt.apply(tvars, jnp.asarray(img), jnp.asarray(pe), jnp.asarray(pts))
    with torch.no_grad():
        q_got, k_got = model.mask_decoder.transformer(
            torch.from_numpy(img), torch.from_numpy(pe), torch.from_numpy(pts))
    np.testing.assert_allclose(q_got.numpy(), np.asarray(q_want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(k_got.numpy(), np.asarray(k_want).reshape(k_got.shape),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax_default(tiny, multimask):
    """Prompt encoder + mask decoder against the JAX package's default
    decoder (twoway_impl and upscale_impl "fused") on cached features."""
    jmodel, jvars, model = tiny
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(1, 6, 6, 32)).astype(np.float32)
    pts = np.sort(rng.uniform(0, 96, (5, 2, 2)), axis=1).astype(np.float32)
    labs = np.tile(np.array([[2, 3]], np.int32), (5, 1))
    predict = jax.jit(lambda v, *a: jmodel.apply(v, *a, None, multimask, method=JaxSam.predict))
    want_low, want_iou = predict(jvars, jnp.asarray(feats), jnp.asarray(pts), jnp.asarray(labs))
    low, iou = model.predict(torch.from_numpy(feats), torch.from_numpy(pts),
                             torch.from_numpy(labs).long(), None, multimask)
    assert tuple(low.shape) == want_low.shape == (5, 3 if multimask else 1, 24, 24)
    np.testing.assert_allclose(low.numpy(), np.asarray(want_low), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=1e-5, rtol=1e-5)


def test_predict_boxes_lowres_matches_jax(tiny):
    """Device-resident decode of 5 boxes (bucket 16, padded rows included)."""
    jmodel, jvars, model = tiny
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (80, 56, 3), dtype=np.uint8)
    boxes = np.array([[2, 3, 30, 40], [10, 20, 55, 79], [0, 0, 55, 79],
                      [20, 5, 28, 15], [5, 50, 40, 70]], np.float32)
    jp = JaxPredictor(jmodel, jvars)
    jp.set_image(img)
    want_low, want_iou = jp.predict_boxes_lowres(boxes)
    p = SamPredictor(model)
    p.set_image(img)
    low, iou = p.predict_boxes_lowres(boxes)
    assert isinstance(low, torch.Tensor) and tuple(low.shape) == want_low.shape == (16, 1, 24, 24)
    np.testing.assert_allclose(low.numpy(), np.asarray(want_low), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=1e-3, rtol=1e-3)

    # set_image_features installs the same state as set_image
    q = SamPredictor(model)
    q.set_image_features(p.features, p.original_size, p.input_size)
    np.testing.assert_array_equal(q.predict_boxes_lowres(boxes)[0].numpy(), low.numpy())


@pytest.mark.parametrize("width", [1, 7, 8, 9, 61, 64])
def test_packbits2d_matches_numpy(width):
    m = np.random.default_rng(width).random((3, 5, width)) > 0.5
    packed = packbits2d(torch.from_numpy(m))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.packbits(m, axis=-1))
    np.testing.assert_array_equal(unpackbits2d(packed.numpy(), width), m)


def test_loaders_match_jax(tmp_path):
    (tmp_path / "d.xml").write_text(DIOR_XML)
    (tmp_path / "h.xml").write_text(HRSC_XML)
    (tmp_path / "f.txt").write_text(FAIR1M_TXT)
    (tmp_path / "e.xml").write_text("<annotation></annotation>")
    for ours, theirs, name in ((loaders.load_dior, jax_loaders.load_dior, "d"),
                               (loaders.load_hrsc, jax_loaders.load_hrsc, "h"),
                               (loaders.load_dota, jax_loaders.load_dota, "f"),
                               (loaders.load_dior, jax_loaders.load_dior, "e")):
        got, want = ours(name, str(tmp_path)), theirs(name, str(tmp_path))
        for field in ("hboxes", "polys", "points", "labels", "colors"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
        assert (got.class_names, got.error, got.num_instances) == \
            (want.class_names, want.error, want.num_instances)
    assert set(loaders.LOADERS) == set(jax_loaders.LOADERS)


def test_geometry_and_constants_match_jax():
    rng = np.random.default_rng(9)
    obb = np.concatenate([rng.uniform(0, 100, (6, 2)), rng.uniform(5, 40, (6, 2)),
                          rng.uniform(-np.pi, np.pi, (6, 1))], 1)
    np.testing.assert_array_equal(obb2poly(obb), jax_obb2poly(obb))
    polys = rng.uniform(0, 100, (6, 8))
    np.testing.assert_array_equal(poly_to_hbb(polys), jax_poly_to_hbb(polys))
    np.testing.assert_array_equal(mapping.PALETTE, jax_mapping.PALETTE)
    assert mapping.CLASS_SETS == jax_mapping.CLASS_SETS
    assert mapping.NAME_TO_INDEX == jax_mapping.NAME_TO_INDEX


@pytest.mark.parametrize("case", ["random", "empty", "full", "first-pixel-on"])
def test_rle_matches_jax(case):
    m = np.random.default_rng(2).random((37, 53)) > 0.6
    if case == "empty":
        m[:] = False
    elif case == "full":
        m[:] = True
    elif case == "first-pixel-on":
        m[0, 0] = True
    got, want = rle_encode(m), jax_rle_encode(m)
    as_bytes = lambda c: c.encode("ascii") if isinstance(c, str) else bytes(c)
    assert got["size"] == list(want["size"]) and as_bytes(got["counts"]) == as_bytes(want["counts"])
    np.testing.assert_array_equal(rle_decode(got), m.astype(np.uint8))
    np.testing.assert_array_equal(rle_decode(got), jax_rle_decode(want))


def _mini_dataset(root):
    """Two 60x80 images with two DIOR boxes each (tests/test_generate.py's set)."""
    img_dir, ann_dir = root / "images", root / "anns"
    img_dir.mkdir()
    ann_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray((rng.random((60, 80, 3)) * 255).astype(np.uint8)).save(img_dir / f"im{i}.png")
        (ann_dir / f"im{i}.xml").write_text(DIOR_XML)
    return str(img_dir), str(ann_dir)


def _mask_iou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


def _assert_records_match(got, want, rotated=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["label"], g["category"]) == (w["label"], w["category"])
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
        if rotated:
            np.testing.assert_array_equal(g["rbox"], w["rbox"])
            np.testing.assert_array_equal(g["rhbox"], w["rhbox"])
        mg, mw = rle_decode(g["mask"]), jax_rle_decode(w["mask"])
        assert int(mg.sum()) == g["size"]
        # fp32 sums differ only in order: only pixels at the threshold may flip
        assert _mask_iou(mg.astype(bool), mw.astype(bool)) >= 0.999


def test_generate_semantic_matches_jax(tiny, tmp_path):
    """The whole driver, annotations to PNGs and pkls, against JAX's
    generate_semantic with the same weights and buckets (4, 16)."""
    jmodel, jvars, model = tiny
    img_dir, ann_dir = _mini_dataset(tmp_path)
    out = {}
    for side in ("jax", "port"):
        save_dir = str(tmp_path / side)
        if side == "jax":
            cfg = JaxGenerateConfig(dataset="dior", image_dir=img_dir, ann_dir=ann_dir,
                                    save_dir=save_dir)
            n = jax_generate_semantic(cfg, predictor=JaxPredictor(jmodel, jvars, buckets=(4, 16)))
        else:
            cfg = GenerateConfig(dataset="dior", image_dir=img_dir, ann_dir=ann_dir,
                                 save_dir=save_dir, device="cpu")
            n = generate_semantic(cfg, predictor=SamPredictor(model, buckets=(4, 16)))
        assert n == 2
        out[side] = save_dir
    for i in range(2):
        read = lambda side, kind: np.asarray(Image.open(os.path.join(out[side], kind, f"im{i}.png")))
        gray, gray_want = read("port", "gray"), read("jax", "gray")
        assert gray.shape == (60, 80) and (gray == gray_want).mean() >= 0.999
        np.testing.assert_array_equal(read("port", "color"), mapping.PALETTE[gray])
        load = lambda side: pickle.load(open(os.path.join(out[side], "ins", f"im{i}.pkl"), "rb"))
        records = load("port")
        assert isinstance(records[0]["mask"]["counts"], str)
        _assert_records_match(records, load("jax"))


def test_process_with_set_image_rotated_matches_jax(tiny, tmp_path):
    """The rotated-box pipeline on a FAIR1M-style annotation: prompts are the
    polygons' enclosing hboxes; records carry rbox and rhbox."""
    jmodel, jvars, model = tiny
    (tmp_path / "f.txt").write_text(FAIR1M_TXT)
    ann = loaders.load_dota("f", str(tmp_path))
    img = np.random.default_rng(12).integers(0, 256, (64, 72, 3), dtype=np.uint8)
    jp = JaxPredictor(jmodel, jvars, buckets=(4, 16))
    jp.set_image(img)
    want = JaxGenerator(jp, jax_mapping.CLASS_SETS["fair1m"]).process_with_set_image(
        img.shape[:2], jax_loaders.load_dota("f", str(tmp_path)), rotated=True)
    p = SamPredictor(model, buckets=(4, 16))
    p.set_image(img)
    got = SemanticGenerator(p, mapping.CLASS_SETS["fair1m"]).process_with_set_image(
        img.shape[:2], ann, rotated=True)
    assert got.n_instances == want.n_instances == 3
    assert (got.gray == want.gray).mean() >= 0.999
    np.testing.assert_array_equal(got.color, mapping.PALETTE[got.gray])
    _assert_records_match(got.records, want.records, rotated=True)
