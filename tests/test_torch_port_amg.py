"""The port's automatic mask generator (samrs_tpu_torch) vs the JAX package,
on CPU in fp32.

The host helpers of ``sam/amg.py`` on fixed and seeded inputs;
``remove_small_regions`` (scipy's labelling) against the JAX function (cv2's);
``SamPredictor.amg_sweep`` against the JAX predictor's ``_amg_chunk``; and a
whole ``generate`` of a tiny SAM, bridged from the JAX variables, against the
JAX generator.  Inputs are made with numpy from seeds and handed to both
sides.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from samrs_tpu.core.config import sam_config as jax_sam_config
from samrs_tpu.sam import amg as jax_amg
from samrs_tpu.sam import Sam as JaxSam
from samrs_tpu.sam.automatic_mask_generator import \
    SamAutomaticMaskGenerator as JaxGenerator
from samrs_tpu.sam.predictor import SamPredictor as JaxPredictor
from samrs_tpu_torch.core.config import sam_config
from samrs_tpu_torch.sam import SamAutomaticMaskGenerator, SamPredictor, amg, build_sam
from samrs_tpu_torch.sam.port import jax_params_to_torch
from test_torch_port_generate import TINY, _fp32_matmuls, _random_variables  # noqa: F401

NEAR = 1e-4  # a pixel this close to a threshold may flip between the two fp32 resizes
# tests/test_amg.py's generator settings
AMG = dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
           stability_score_thresh=0.0)
BUCKETS = (16, 64)
IMAGE_HW = (48, 64)


@pytest.fixture(scope="module")
def tiny():
    """(JAX predictor, port model) on the same drawn variables."""
    jmodel = JaxSam(jax_sam_config("vit_b", **TINY, compute_dtype="float32"))
    jvars = _random_variables(jmodel, seed=19)
    model = build_sam("vit_b", device="cpu", **TINY)
    model.load_state_dict(jax_params_to_torch(jvars, sam_config("vit_b", **TINY)), strict=True)
    return JaxPredictor(jmodel, jvars, buckets=BUCKETS), model


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(3).integers(0, 256, (*IMAGE_HW, 3), dtype=np.uint8)


def test_mask_data_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(6, 2)), [f"x{i}" for i in range(6)]
    got, want = amg.MaskData(a=a.copy(), b=list(b)), jax_amg.MaskData(a=a.copy(), b=list(b))
    for keep in (np.array([True, False, True, True, False, True]), np.array([3, 0, 2])):
        got.filter(keep)
        want.filter(keep)
    more = dict(a=rng.normal(size=(2, 2)), b=["y0", "y1"])
    got.cat(amg.MaskData(**more))
    want.cat(jax_amg.MaskData(**more))
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["b"] == want["b"]
    with pytest.raises(TypeError):
        amg.MaskData(a=(1, 2))


def test_stability_score_matches_jax():
    masks = np.random.default_rng(1).normal(size=(5, 20, 30)).astype(np.float32) * 3
    np.testing.assert_array_equal(amg.calculate_stability_score(masks, 0.0, 1.0),
                                  jax_amg.calculate_stability_score(masks, 0.0, 1.0))


@pytest.mark.parametrize("n,layers,scale", [(4, 0, 1), (32, 0, 1), (32, 2, 2), (10, 1, 3)])
def test_point_grids_match_jax(n, layers, scale):
    got = amg.build_all_layer_point_grids(n, layers, scale)
    want = jax_amg.build_all_layer_point_grids(n, layers, scale)
    assert len(got) == len(want) == layers + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hw,layers,overlap", [((48, 64), 1, 512 / 1500), ((1024, 1024), 2, 0.2),
                                               ((600, 800), 1, 512 / 1500), ((100, 200), 3, 0.3)])
def test_crop_boxes_match_jax(hw, layers, overlap):
    assert amg.generate_crop_boxes(hw, layers, overlap) == \
        jax_amg.generate_crop_boxes(hw, layers, overlap)


def test_uncrop_matches_jax():
    rng = np.random.default_rng(2)
    boxes = rng.integers(0, 30, (7, 4))
    points = rng.uniform(0, 30, (7, 2))
    masks = rng.random((3, 8, 10)) > 0.5
    for crop in ([2, 3, 12, 11], [0, 0, 20, 16]):
        np.testing.assert_array_equal(amg.uncrop_boxes_xyxy(boxes, crop),
                                      jax_amg.uncrop_boxes_xyxy(boxes, crop))
        np.testing.assert_array_equal(amg.uncrop_points(points, crop),
                                      jax_amg.uncrop_points(points, crop))
    for crop, (h, w) in (([2, 3, 12, 11], (16, 20)), ([0, 0, 10, 8], (8, 10))):
        np.testing.assert_array_equal(amg.uncrop_masks(masks, crop, h, w),
                                      jax_amg.uncrop_masks(masks, crop, h, w))


def test_box_near_crop_edge_matches_jax():
    rng = np.random.default_rng(4)
    x0y0 = rng.integers(0, 300, (200, 2))
    boxes = np.concatenate([x0y0, x0y0 + rng.integers(1, 300, (200, 2))], 1)
    for crop, orig in (([0, 0, 400, 300], [0, 0, 400, 300]), ([100, 50, 380, 290],
                                                               [0, 0, 600, 400])):
        got = amg.is_box_near_crop_edge(boxes, crop, orig)
        np.testing.assert_array_equal(got, jax_amg.is_box_near_crop_edge(boxes, crop, orig))
    assert got.any() and not got.all()


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_box_nms_matches_jax(thresh):
    """Seeded boxes with tied scores: the same kept indices in the same order."""
    rng = np.random.default_rng(5)
    x0y0 = rng.uniform(0, 100, (300, 2))
    boxes = np.concatenate([x0y0, x0y0 + rng.uniform(5, 60, (300, 2))], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, 300), 1)  # ~30 boxes a score
    got = amg.box_nms(boxes, scores, thresh)
    np.testing.assert_array_equal(got, jax_amg.box_nms(boxes, scores, thresh))
    assert got.dtype == np.int64 and 10 < len(got) < 300
    assert amg.box_nms(np.zeros((0, 4), np.float32), np.zeros(0), thresh).shape == (0,)


def test_batched_mask_to_box_matches_jax():
    rng = np.random.default_rng(6)
    masks = rng.random((2, 9, 17, 23)) > 0.97
    masks[0, 0] = False  # empty
    masks[1, 3] = False
    masks[1, 3, 16, 22] = True  # one pixel in the corner
    got = amg.batched_mask_to_box(masks)
    np.testing.assert_array_equal(got, jax_amg.batched_mask_to_box(masks))
    assert got.shape == (2, 9, 4) and got.dtype == np.int64


def test_rle_helpers_match_jax():
    """Uncompressed RLE equal, its round trip, and the compressed counts byte-equal."""
    rng = np.random.default_rng(7)
    masks = [rng.random((13, 17)) > 0.5, np.ones((5, 4), bool), np.zeros((6, 3), bool),
             rng.random((200, 300)) > 0.9]
    for m in masks:
        rle = amg.mask_to_rle(m)
        want = jax_amg.mask_to_rle(m)
        assert rle == want and all(type(c) is int for c in rle["counts"])
        np.testing.assert_array_equal(amg.rle_to_mask(rle), m)
        assert amg.area_from_rle(rle) == jax_amg.area_from_rle(want) == int(m.sum())
        coco = amg.coco_encode_rle(rle)
        assert coco == jax_amg.coco_encode_rle(want) and isinstance(coco["counts"], str)


def _blobs(rng, n, hw=(40, 48)):
    """Seeded masks of a few blobs with holes: uniform noise smoothed and
    thresholded."""
    noise = rng.random((n, *hw))
    smooth = ndimage.uniform_filter(noise, size=(1, 5, 5))
    return smooth > rng.uniform(0.45, 0.55, (n, 1, 1))


def _tied_for_largest(mask, mode, area):
    """True where `mode` leaves only small regions and two tie for largest:
    the one case where cv2's label order can pick another region."""
    work = ~mask if mode == "holes" else mask
    labels, n = ndimage.label(work, structure=np.ones((3, 3)))
    sizes = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    return mode == "islands" and n and sizes.max() < area and (sizes == sizes.max()).sum() > 1


@pytest.mark.parametrize("area", [5, 40, 200])
def test_remove_small_regions_matches_cv2(area):
    """Against the JAX function, which labels with cv2, on 200 seeded masks
    without a tie for the largest region (that case is the next test's)."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(8)
    changed = 0
    for m in _blobs(rng, 200):
        for mode in ("holes", "islands"):
            assert not _tied_for_largest(m, mode, area)
            got, got_changed = amg.remove_small_regions(m, area, mode)
            want, want_changed = jax_amg.remove_small_regions(m, area, mode)
            np.testing.assert_array_equal(got, want)
            assert got_changed == want_changed
            changed += got_changed
    assert changed > 50


def test_remove_small_regions_tie_keeps_first_in_raster_order():
    """Islands mode with every island small keeps the largest; of two tied
    for largest, the first in raster order (scipy's label order)."""
    m = np.zeros((12, 12), bool)
    m[8:10, 1:4] = True   # 6 px from row 8
    m[1:3, 7:10] = True   # 6 px from row 1: first in raster order
    m[5, 5] = True        # 1 px
    out, changed = amg.remove_small_regions(m, 10, "islands")
    assert changed
    want = np.zeros_like(m)
    want[1:3, 7:10] = True
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError):
        amg.remove_small_regions(m, 10, "both")


def _grid_prompts(pred, n_side=4, nb=16):
    """The generator's first chunk: the grid's points as single-point prompt
    sets in the model's frame, padded to nb."""
    h, w = pred.original_size
    points = amg.build_point_grid(n_side) * np.array([[w, h]])
    pts = np.zeros((nb, 2, 2), np.float32)
    labs = np.full((nb, 2), -1, np.int32)
    pts[:len(points), 0] = pred.transform.apply_coords(points.astype(np.float32), (h, w))
    labs[:len(points), 0] = 1
    return pts, labs


def test_amg_sweep_stats_match_jax(tiny, image):
    """amg_sweep's stats (K7's plain version) against the JAX predictor's
    _amg_chunk (two resizes) on the CPU: IoU predictions within 1e-5;
    hi, lo and boxes equal except at pixels within 1e-4 of a threshold;
    the bits equal elsewhere."""
    jp, model = tiny
    jp.set_image(image)
    p = SamPredictor(model, buckets=BUCKETS)
    p.set_image(image)
    pts, labs = _grid_prompts(jp)
    offset = 1.0
    args = (tuple(jp.input_size), tuple(jp.original_size), offset)
    want_stats, want_bits = (np.asarray(a) for a in jp._amg_chunk(
        jp.variables, jp.features, jnp.asarray(pts), jnp.asarray(labs), *args))
    stats, packed = p.amg_sweep(pts[None], labs[None].astype(np.int64), offset)
    stats = stats.numpy()
    assert stats.shape == want_stats.shape == (16, 3, 7)
    assert tuple(packed.shape) == (48, 48, 8) and packed.dtype == torch.uint8
    np.testing.assert_allclose(stats[..., 0], want_stats[..., 0], atol=1e-5, rtol=1e-5)
    low, _ = jp._decode(jp.variables, jp.features, jnp.asarray(pts), jnp.asarray(labs), None,
                        True)
    logits = np.asarray(jp._postprocess(low, *args[:2], False)).reshape(48, *IMAGE_HW)
    mt = model.cfg.mask_threshold
    near = [np.abs(logits - t).reshape(48, -1) < NEAR for t in (mt, mt + offset, mt - offset)]
    got_hi, got_lo = stats[..., 1].reshape(-1), stats[..., 2].reshape(-1)
    want_hi, want_lo = want_stats[..., 1].reshape(-1), want_stats[..., 2].reshape(-1)
    assert (np.abs(got_hi - want_hi) <= near[1].sum(1)).all()
    assert (np.abs(got_lo - want_lo) <= near[2].sum(1)).all()
    far = ~near[0].any(1)
    np.testing.assert_array_equal(stats[..., 3:].reshape(-1, 4)[far],
                                  want_stats[..., 3:].reshape(-1, 4)[far])
    bits = np.unpackbits(packed.numpy(), axis=-1)[..., :IMAGE_HW[1]].reshape(48, -1)
    want = np.unpackbits(want_bits.reshape(48, *IMAGE_HW[:1], -1), axis=-1)[..., :IMAGE_HW[1]]
    assert ((bits != want.reshape(48, -1)) & ~near[0]).sum() == 0
    assert 0 < bits.mean() < 1
    took = p.amg_take_packed(packed, np.array([5, 0, 47]))
    np.testing.assert_array_equal(took, packed.numpy()[[5, 0, 47]])
    assert p.amg_take_packed(packed, np.zeros(0, np.int64)).shape == (0, 48, 8)


def test_generator_signature_matches_jax():
    got = inspect.signature(SamAutomaticMaskGenerator.__init__).parameters
    want = inspect.signature(JaxGenerator.__init__).parameters
    assert list(got) == list(want)
    for k in got:
        assert got[k].default == want[k].default, k


def _seg_iou(a, b):
    inter, union = np.logical_and(a, b).sum(), np.logical_or(a, b).sum()
    return 1.0 if union == 0 else inter / union


def _filters_at_medians(jp, image, kw):
    """pred_iou_thresh and stability_score_thresh at the medians of the JAX
    generator's unfiltered records, so the filters keep about half."""
    recs = JaxGenerator(jp, **kw).generate(image)
    return dict(pred_iou_thresh=float(np.median([r["predicted_iou"] for r in recs])),
                stability_score_thresh=float(np.median([r["stability_score"] for r in recs])))


@pytest.mark.parametrize("output_mode", ["binary_mask", "uncompressed_rle", "coco_rle"])
@pytest.mark.parametrize("crops,min_area,nms,filters", [(0, 0, 0.7, False), (1, 20, 0.7, False),
                                                        (0, 0, 1.0, False), (1, 20, 1.0, True)])
def test_generate_matches_jax(tiny, image, output_mode, crops, min_area, nms, filters):
    """The whole generator against the JAX generator: the same records in
    the same order, bbox / point_coords / crop_box equal, predicted_iou and
    stability_score within 1e-5, segmentation IoU >= 0.999.  The tiny
    model's masks span the image, so at the NMS's default 0.7 one record is
    left; at 1.0 the NMS keeps every box, and with the filters at the
    records' medians about half stay."""
    jp, model = tiny
    kw = dict(AMG, crop_n_layers=crops, min_mask_region_area=min_area, box_nms_thresh=nms,
              crop_nms_thresh=nms, output_mode=output_mode)
    if filters:
        kw.update(_filters_at_medians(jp, image, kw))
    want = JaxGenerator(jp, **kw).generate(image)
    got = SamAutomaticMaskGenerator(SamPredictor(model, buckets=BUCKETS), **kw).generate(image)
    assert len(got) == len(want) > 0
    if nms == 1.0 and not filters:
        assert len(got) > 30
    decode = {"binary_mask": lambda s: s, "uncompressed_rle": amg.rle_to_mask,
              "coco_rle": lambda s: amg.rle_to_mask(s).astype(bool)}[output_mode]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("bbox", "point_coords", "crop_box", "area"):
            assert g[k] == w[k], k
        for k in ("predicted_iou", "stability_score"):
            assert abs(g[k] - w[k]) <= 1e-5, k
        assert type(g["segmentation"]) is type(w["segmentation"])
        assert _seg_iou(decode(g["segmentation"]), decode(w["segmentation"])) >= 0.999
        if output_mode != "binary_mask":
            assert g["segmentation"] == w["segmentation"]
