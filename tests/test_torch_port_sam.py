"""PyTorch port of SAM (samrs_tpu_torch) vs the JAX package, on CPU in fp32.

A tiny SAM whose windows pad (grid 6, window 4) gets its variable tree from
the JAX model, every parameter drawn with numpy (none left at zero), and is
bridged with ``jax_params_to_torch`` and loaded strictly into the port.  Inputs are made
with numpy from a seed and handed to both sides.
"""

import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.core.config import sam_config as jax_sam_config
from samrs_tpu.sam import Sam as JaxSam
from samrs_tpu.sam.build import init_sam_variables
from samrs_tpu.sam.port import flax_sam_to_torch
from samrs_tpu.sam.predictor import SamPredictor as JaxPredictor
from samrs_tpu.sam.sam import postprocess_masks as jax_postprocess_masks
from samrs_tpu.sam.transforms import ResizeLongestSide as JaxResize
from samrs_tpu_torch.core.config import SamConfig, sam_config
from samrs_tpu_torch.sam import SamPredictor, build_sam
from samrs_tpu_torch.sam.port import jax_params_to_torch
from samrs_tpu_torch.sam.sam import postprocess_masks
from samrs_tpu_torch.sam.transforms import ResizeLongestSide

REPO = Path(__file__).resolve().parent.parent
TINY = dict(image_size=96, patch_size=16, window_size=4, encoder_embed_dim=32,
            encoder_depth=3, encoder_num_heads=2, encoder_global_attn_indexes=(2,),
            prompt_embed_dim=32, mask_in_chans=8, decoder_mlp_dim=64, decoder_num_heads=2,
            iou_head_hidden_dim=32)
TOL = 1e-4  # fp32 both sides; only summation order differs


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    """State fp32 for the port's matmuls and convs (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX variables as numpy, port model).

    The JAX variable tree comes from ``jax.eval_shape`` of the model's init
    (a trace, no compile) and every leaf is drawn with numpy, so none of the
    parameters that the init leaves at zero (rel-pos tables, pos_embed,
    biases) stays zero and hides a bug."""
    jcfg = jax_sam_config("vit_b", **TINY, compute_dtype="float32",
                          twoway_impl="xla", upscale_impl="xla")
    jmodel = JaxSam(jcfg)
    shapes = jax.eval_shape(lambda: init_sam_variables(jmodel, seed=0))
    flat = flax.traverse_util.flatten_dict(shapes)
    rng = np.random.default_rng(1)
    for k, s in sorted(flat.items()):
        v = rng.normal(size=s.shape).astype(np.float32)
        if k[-1] == "scale":
            v = 1.0 + 0.1 * v
        elif k[-1] == "kernel":
            v = v * np.prod(s.shape[:-1]) ** -0.5
        else:
            v = 0.1 * v
        flat[k] = v.astype(np.float32)
    jvars = flax.traverse_util.unflatten_dict(flat)
    model = build_sam("vit_b", device="cpu", **TINY)
    model.load_state_dict(jax_params_to_torch(jvars, sam_config("vit_b", **TINY)), strict=True)
    return jmodel, jvars, model


def _jax_apply(jmodel, method, **static):
    """Jitted JAX apply (one compile instead of op-by-op dispatch)."""
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=method, **static))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("variant", ["vit_b", "vit_l", "vit_h"])
def test_config_matches_jax(variant):
    want = jax_sam_config(variant)
    got = sam_config(variant)
    for f in SamConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert got.grid_size == want.grid_size


def test_weight_bridge_matches_flax_sam_to_torch(tiny):
    _, jvars, model = tiny
    ours = jax_params_to_torch(jvars, sam_config("vit_b", **TINY))
    ref = flax_sam_to_torch(jvars, jax_sam_config("vit_b", **TINY))
    assert list(ours) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert set(ours) == set(model.state_dict())


def test_encoder_matches_jax(tiny):
    jmodel, jvars, model = tiny
    x = np.random.default_rng(2).normal(size=(2, 96, 96, 3)).astype(np.float32)
    want = np.asarray(_jax_apply(jmodel, JaxSam.encode_image)(jvars, jnp.asarray(x)))
    got = model.encode_image(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 6, 6, 32)
    assert _rel_l2(got, want) <= TOL


def test_prompt_encoder_matches_jax(tiny):
    jmodel, jvars, model = tiny
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 96, (3, 5, 2)).astype(np.float32)
    labs = np.array([[-1, 0, 1, 2, 3], [2, 3, -1, -1, 1], [0, 0, 1, 1, -1]], np.int32)
    masks = rng.normal(size=(3, 24, 24, 1)).astype(np.float32)
    for m in (None, masks):
        want = _jax_apply(jmodel, JaxSam.encode_prompts)(
            jvars, jnp.asarray(pts), jnp.asarray(labs), None if m is None else jnp.asarray(m))
        got = model.prompt_encoder(torch.from_numpy(pts), torch.from_numpy(labs).long(),
                                   None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(model.prompt_encoder.get_dense_pe().numpy(),
                               np.asarray(jmodel.apply(jvars, method=JaxSam.dense_pe)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("multimask", [False, True])
def test_decoder_matches_jax(tiny, multimask):
    jmodel, jvars, model = tiny
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(1, 6, 6, 32)).astype(np.float32)
    pts = rng.uniform(0, 96, (5, 2, 2)).astype(np.float32)
    labs = np.tile(np.array([[2, 3]], np.int32), (5, 1))
    labs[4] = (1, -1)  # a point prompt with its not-a-point pad
    want_low, want_iou = _jax_apply(jmodel, JaxSam.predict, multimask_output=multimask)(
        jvars, jnp.asarray(feats), jnp.asarray(pts), jnp.asarray(labs))
    low, iou = model.predict(torch.from_numpy(feats), torch.from_numpy(pts),
                             torch.from_numpy(labs).long(), None, multimask)
    assert tuple(low.shape) == want_low.shape == (5, 3 if multimask else 1, 24, 24)
    np.testing.assert_allclose(low.numpy(), np.asarray(want_low), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=TOL, rtol=TOL)


def test_postprocess_matches_jax():
    low = np.random.default_rng(5).normal(size=(2, 1, 24, 24)).astype(np.float32)
    want = jax_postprocess_masks(jnp.asarray(low), (96, 67), (80, 56), 96)
    got = postprocess_masks(torch.from_numpy(low), (96, 67), (80, 56), 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hw", [(80, 56), (300, 211), (33, 97), (96, 64)])
def test_resize_matches_reference_pil(hw):
    """The numpy resize reproduces the reference's PIL bilinear exactly."""
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ResizeLongestSide(96).apply_image(img),
                                  JaxResize(96).apply_image(img))


def test_predictor_boxes_match_jax(tiny):
    """set_image on a non-square uint8 image (resized and pad-masked), then
    five boxes through predict_boxes (bucket 16)."""
    jmodel, jvars, model = tiny
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (80, 56, 3), dtype=np.uint8)
    boxes = np.array([[2, 3, 30, 40], [10, 20, 55, 79], [0, 0, 55, 79],
                      [20, 5, 28, 15], [5, 50, 40, 70]], np.float32)
    jp = JaxPredictor(jmodel, jvars)
    jp.set_image(img)
    want_masks, want_iou, want_low = jp.predict_boxes(boxes)
    p = SamPredictor(model)
    p.set_image(img)
    masks, iou, low = p.predict_boxes(boxes)
    assert masks.shape == want_masks.shape == (5, 1, 80, 56) and masks.dtype == bool
    np.testing.assert_allclose(low, want_low, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(iou, want_iou, atol=1e-3, rtol=1e-3)
    # logits within 1e-3 of 0 may flip the threshold
    assert (masks == want_masks).mean() >= 0.999
    np.testing.assert_allclose(p.get_image_embedding().numpy(), np.asarray(jp.features),
                               atol=1e-3, rtol=1e-3)


def test_predictor_single_prompt_matches_jax(tiny):
    """predict() with points + box and multimask output."""
    jmodel, jvars, model = tiny
    img = np.random.default_rng(8).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    kw = dict(point_coords=np.array([[30.0, 20.0], [50.0, 40.0]], np.float32),
              point_labels=np.array([1, 0]), box=np.array([10, 5, 80, 60], np.float32))
    jp = JaxPredictor(jmodel, jvars)
    jp.set_image(img)
    want = jp.predict(**kw)
    p = SamPredictor(model)
    p.set_image(img)
    got = p.predict(**kw)
    assert got[0].shape == want[0].shape == (3, 64, 96)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got[2], want[2], atol=1e-3, rtol=1e-3)
    assert (got[0] == want[0]).mean() >= 0.999


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, pulls in no JAX."""
    code = (
        "import importlib, pkgutil, sys, samrs_tpu_torch\n"
        "for m in pkgutil.walk_packages(samrs_tpu_torch.__path__, 'samrs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules\n"
        "       if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'samrs_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
