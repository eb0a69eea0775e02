"""The port's HRSC prompt evaluation (samrs_tpu_torch) vs the JAX package, on
CPU in fp32.

``SamPredictor.predict_points`` / ``predict_mask_prompts`` against the JAX
predictor's, ``run_prompt_eval`` in all five prompt modes against the JAX
harness (metrics, the COCO JSON field for field), the mask-prompt canvases
and the polygon rasteriser against the cv2 versions, and the host helpers.
A tiny SAM is bridged from drawn JAX variables; inputs are made with numpy
from seeds and handed to both sides.
"""

import json
import os
import tempfile

import numpy as np
import pytest
from PIL import Image

from samrs_tpu.core.config import sam_config as jax_sam_config
from samrs_tpu.generate import instance_eval as jax_eval
from samrs_tpu.sam import Sam as JaxSam
from samrs_tpu.sam.predictor import SamPredictor as JaxPredictor
from samrs_tpu.tools import instance_to_json as jax_json
from samrs_tpu.tools.visualize import overlay_instances as jax_overlay
from samrs_tpu_torch.core.config import sam_config
from samrs_tpu_torch.data.loaders import load_hrsc
from samrs_tpu_torch.generate import instance_eval
from samrs_tpu_torch.sam import SamPredictor, build_sam
from samrs_tpu_torch.sam.port import jax_params_to_torch
from samrs_tpu_torch.tools import instance_to_json
from samrs_tpu_torch.tools.visualize import overlay_instances
from test_torch_port_generate import TINY, _fp32_matmuls, _random_variables  # noqa: F401

BUCKETS = (4, 16)

# tests/test_instance_eval.py's scene
HRSC_XML = """<HRSC_Image><HRSC_Objects>
  <HRSC_Object>
    <box_xmin>10</box_xmin><box_ymin>10</box_ymin>
    <box_xmax>40</box_xmax><box_ymax>30</box_ymax>
    <mbox_cx>25</mbox_cx><mbox_cy>20</mbox_cy>
    <mbox_w>30</mbox_w><mbox_h>16</mbox_h><mbox_ang>0.3</mbox_ang>
    <seg_color>200,30,30</seg_color>
  </HRSC_Object>
  <HRSC_Object>
    <box_xmin>45</box_xmin><box_ymin>35</box_ymin>
    <box_xmax>75</box_xmax><box_ymax>55</box_ymax>
    <mbox_cx>60</mbox_cx><mbox_cy>45</mbox_cy>
    <mbox_w>28</mbox_w><mbox_h>14</mbox_h><mbox_ang>-0.2</mbox_ang>
    <seg_color>30,200,30</seg_color>
  </HRSC_Object>
</HRSC_Objects></HRSC_Image>"""


@pytest.fixture()
def hrsc_dataset(tmp_path):
    (tmp_path / "img").mkdir()
    (tmp_path / "ann").mkdir()
    (tmp_path / "land").mkdir()
    rng = np.random.default_rng(0)
    img = (rng.random((60, 80, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "img" / "h0.png")
    (tmp_path / "ann" / "h0.xml").write_text(HRSC_XML)
    land = np.zeros((60, 80, 3), np.uint8)
    land[12:28, 12:38] = (200, 30, 30)
    land[37:53, 47:73] = (30, 200, 30)
    Image.fromarray(land).save(tmp_path / "land" / "h0.png")
    return tmp_path


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its drawn variables, port model) on the same weights."""
    jmodel = JaxSam(jax_sam_config("vit_b", **TINY, compute_dtype="float32"))
    jvars = _random_variables(jmodel, seed=23)
    model = build_sam("vit_b", device="cpu", **TINY)
    model.load_state_dict(jax_params_to_torch(jvars, sam_config("vit_b", **TINY)), strict=True)
    return jmodel, jvars, model


@pytest.fixture(scope="module")
def predictors(tiny):
    """A JAX and a port predictor (their compiled decodes reused by the tests)."""
    jmodel, jvars, model = tiny
    return JaxPredictor(jmodel, jvars, buckets=BUCKETS), SamPredictor(model, buckets=BUCKETS)


def _set(predictors, seed, hw=(60, 80)):
    image = np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)
    for p in predictors:
        p.set_image(image)
    return predictors


@pytest.mark.parametrize("n,multimask", [(3, False), (7, True), (16, False)])
def test_predict_points_matches_jax(predictors, n, multimask):
    jp, p = _set(predictors, 1)
    pts = np.random.default_rng(n).uniform([0, 0], [80, 60], (n, 2)).astype(np.float32)
    want = jp.predict_points(pts, multimask_output=multimask)
    got = p.predict_points(pts, multimask_output=multimask)
    m = 3 if multimask else 1
    assert got[0].shape == want[0].shape == (n, m, 60, 80) and got[0].dtype == bool
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    assert (got[0] == want[0]).mean() >= 0.999


@pytest.mark.parametrize("n", [2, 5])
def test_predict_mask_prompts_matches_jax(predictors, n):
    """Mask-only prompt sets (zero sparse tokens), each with its own canvas."""
    jp, p = _set(predictors, 2)
    canvases = np.random.default_rng(n).normal(size=(n, 24, 24)).astype(np.float32) * 5
    want = jp.predict_mask_prompts(canvases)
    got = p.predict_mask_prompts(canvases)
    assert got[0].shape == want[0].shape == (n, 1, 60, 80)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    assert (got[0] == want[0]).mean() >= 0.999
    # a not-a-point pad is not a mask-only prompt: the decode would differ
    pad = p.predict(point_coords=np.zeros((0, 2), np.float32), point_labels=np.zeros(0),
                    mask_input=canvases[0], multimask_output=False)
    assert np.abs(pad[2][0] - got[2][0, 0]).max() > 1e-3


def test_prompts_to_points_matches_jax(predictors):
    """The one merge of point and box prompts against JAX's, prompt set by
    prompt set, in the predictor's frame."""
    jp, p = _set(predictors, 3)
    coords = np.array([[30.0, 20.0], [50.0, 40.0]])
    labels = np.array([1, 0])
    box = np.array([10.0, 5.0, 70.0, 55.0])
    for kw in (dict(point_coords=coords, point_labels=labels, box=None),
               dict(point_coords=None, point_labels=None, box=box),
               dict(point_coords=coords, point_labels=labels, box=box)):
        want_p, want_l = jp._prompts_to_points(**kw)
        got_p, got_l = p._prompts_to_points(
            None if kw["point_coords"] is None else kw["point_coords"][None],
            None if kw["point_labels"] is None else kw["point_labels"][None],
            None if kw["box"] is None else kw["box"][None])
        np.testing.assert_array_equal(got_p[0], want_p)
        np.testing.assert_array_equal(got_l[0], want_l)
    pts, labs = p._prompts_to_points(None, None, None, n=3)
    assert pts.shape == (3, 0, 2) and labs.shape == (3, 0)


@pytest.mark.parametrize("prompt", instance_eval.PROMPT_MODES)
def test_run_prompt_eval_matches_jax(predictors, hrsc_dataset, prompt):
    """Metrics within 1e-6 of the JAX harness's; the COCO JSON equal field
    for field (RLE strings equal); the overlays equal."""
    jp, p = predictors
    args = [str(hrsc_dataset / d) for d in ("img", "ann", "land")] + [["h0"], prompt]
    out = {}
    for side, pred, run in (("jax", jp, jax_eval.run_prompt_eval),
                            ("port", p, instance_eval.run_prompt_eval)):
        metrics = run(pred, *args, json_dir=str(hrsc_dataset / side),
                      vis_dir=str(hrsc_dataset / f"{side}_vis"))
        docs = [json.loads((hrsc_dataset / side / f"{k}_ins_{prompt}.json").read_text())
                for k in ("gt", "sam")]
        vis = np.asarray(Image.open(hrsc_dataset / f"{side}_vis" / f"out_{prompt}_prompt_h0.png"))
        out[side] = metrics, docs, vis
    (got, got_docs, got_vis), (want, want_docs, want_vis) = out["port"], out["jax"]
    assert set(got) == set(want) and got["num_instances"] == want["num_instances"] == 2
    for k in ("miou_avg", "miou_area"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got_docs[0] == want_docs[0]
    assert len(got_docs[1]) == len(want_docs[1]) == 2
    for g, w in zip(got_docs[1], want_docs[1]):
        assert set(g) == set(w)
        assert g["segmentation"] == w["segmentation"]
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= 1e-5
    np.testing.assert_array_equal(got_vis, want_vis)


def test_instance_eval_cli(hrsc_dataset):
    """``main`` end to end on the CPU with a tiny config; without
    ``--device`` it builds the model on the card, so here it raises."""
    args = ["--prompt", "rbox_mask", "--sam-variant", "vit_b",
            "--image-dir", str(hrsc_dataset / "img"), "--ann-dir", str(hrsc_dataset / "ann"),
            "--landmask-dir", str(hrsc_dataset / "land"), "--json-dir", str(hrsc_dataset / "json")]
    for o in ("image_size=96", "encoder_depth=2", "encoder_global_attn_indexes=1",
              "window_size=4", "encoder_embed_dim=32", "encoder_num_heads=2"):
        args += ["--sam-override", o]
    instance_eval.main(args + ["--device", "cpu"])
    pre = json.loads((hrsc_dataset / "json" / "sam_ins_rbox_mask.json").read_text())
    assert len(pre) == 2 and {"segmentation", "score"} <= set(pre[0])
    with pytest.raises((RuntimeError, AssertionError)):  # no CUDA here
        instance_eval.main(args)


def _rotated_rects(rng, n, hw=(600, 800)):
    """n integer rotated rectangles, one in four crossing the image border."""
    H, W = hw
    out = []
    for i in range(n):
        lo, hi = ((0.0, 1.0) if i % 4 == 0 else (0.15, 0.85))
        c = rng.uniform([lo * W, lo * H], [hi * W, hi * H])
        w, h, a = rng.uniform(4, 220), rng.uniform(2, 60), rng.uniform(-np.pi / 2, np.pi / 2)
        corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        out.append((corners @ rot + c).astype(np.int32))
    return out


def _fixture_polys():
    """The fixture's two rotated boxes as load_hrsc makes them, cast to int32."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "h0.xml"), "w") as f:
            f.write(HRSC_XML)
        return [p.astype(np.int32) for p in load_hrsc("h0", d).polys]


def test_fill_poly_equals_cv2():
    """The rasteriser equals cv2.fillPoly pixel for pixel on 300 seeded
    integer rotated rectangles (75 crossing the border) at 600x800 and the
    fixture's polygons at 60x80."""
    cv2 = pytest.importorskip("cv2")
    cases = [(p, (600, 800)) for p in _rotated_rects(np.random.default_rng(9), 300)]
    cases += [(p, (60, 80)) for p in _fixture_polys()]
    for poly, hw in cases:
        want = np.zeros(hw, np.uint8)
        cv2.fillPoly(want, [poly], 1)
        got = instance_eval.fill_poly(np.zeros(hw, np.uint8), poly)
        np.testing.assert_array_equal(got, want, err_msg=str(poly.tolist()))


@pytest.mark.parametrize("hw,img_size,lowres", [((60, 80), 96, 24), ((600, 800), 1024, 256),
                                                ((333, 517), 1024, 256)])
def test_mask_prompts_match_cv2(hw, img_size, lowres):
    """The hbox and polygon canvases against the JAX functions (cv2's resize,
    border and fillPoly): within 1e-3 on +-1000 canvases."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(hw[0])
    H, W = hw
    boxes = [np.array([10, 10, 40, 30]), np.array([45, 35, 75, 55])]
    for _ in range(10):
        x0, y0 = rng.uniform(0, 0.6 * W), rng.uniform(0, 0.6 * H)
        boxes.append(np.array([x0, y0, x0 + rng.uniform(3, 0.4 * W), y0 + rng.uniform(3, 0.4 * H)]))
    for box in boxes:
        got = instance_eval.box_as_mask_prompt(box, hw, img_size, lowres)
        assert got.shape == (lowres, lowres) and got.dtype == np.float32
        np.testing.assert_allclose(got, jax_eval.box_as_mask_prompt(box, hw, img_size, lowres),
                                   atol=1e-3, rtol=0)
    for poly in _rotated_rects(rng, 10, hw) + _fixture_polys():
        got = instance_eval.poly_as_mask_prompt(poly, hw, img_size, lowres)
        np.testing.assert_allclose(got, jax_eval.poly_as_mask_prompt(poly, hw, img_size, lowres),
                                   atol=1e-3, rtol=0)


def test_host_helpers_match_jax():
    rng = np.random.default_rng(11)
    land = rng.integers(0, 3, (20, 30, 3), dtype=np.uint8) * 100
    colors = np.array([[0, 100, 200], [200, 200, 200], [7, 7, 7]], np.uint8)
    np.testing.assert_array_equal(instance_eval.gt_masks_from_landmask(land, colors),
                                  jax_eval.gt_masks_from_landmask(land, colors))
    preds = [rng.random((3, 20, 30)) > 0.5, rng.random((2, 20, 30)) > 0.7]
    gts = [rng.random((3, 20, 30)) > 0.5, np.zeros((2, 20, 30), bool)]
    assert instance_eval.miou_metrics(preds, gts) == jax_eval.miou_metrics(preds, gts)
    stacks = [p.astype(np.uint8) for p in preds]
    scores = [rng.random(3), rng.random(2)]
    assert instance_to_json.binary_to_coco_gt(stacks, ["a", "b"]) == \
        jax_json.binary_to_coco_gt(stacks, ["a", "b"])
    assert instance_to_json.binary_to_coco_pre(stacks, scores) == \
        jax_json.binary_to_coco_pre(stacks, scores)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    boxes, points = np.array([[2, 3, 20, 15], [-5, 0, 40, 25]]), np.array([[5, 5], [29, 0]])
    np.testing.assert_array_equal(overlay_instances(img, stacks[1], boxes, points),
                                  jax_overlay(img, stacks[1], boxes, points))
