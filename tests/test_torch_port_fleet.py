"""The port's dataset-scale generation slice against the JAX package, on the
CPU in fp32: the painter, ``SamPredictor.encode_images``, ``upscale_chunk``
and ``fetch_masks_packed``, ``sam_forward_batched`` and ``run_fleet`` (with
the tiny SAM of test_torch_port_generate.py, its JAX variables bridged into
the port), the fleet's shards, its refusal without a card and its error
propagation.  JAX's own ``run_fleet`` is not run here (its test is marked
slow).
"""

import os
import pickle
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from samrs_tpu.core.config import GenerateConfig as JaxGenerateConfig
from samrs_tpu.data.rle import rle_decode as jax_rle_decode
from samrs_tpu.generate.painter import _update_cover as jax_update_cover
from samrs_tpu.generate.painter import paint_semantic as jax_paint_semantic
from samrs_tpu.generate.painter import paint_semantic_device as jax_paint_semantic_device
from samrs_tpu.generate.semantic import generate_semantic as jax_generate_semantic
from samrs_tpu.sam.api import sam_forward_batched as jax_sam_forward_batched
from samrs_tpu.sam.predictor import SamPredictor as JaxPredictor
from samrs_tpu_torch.core.config import GenerateConfig
from samrs_tpu_torch.data import mapping
from samrs_tpu_torch.data.rle import rle_decode
from samrs_tpu_torch.generate import fleet, painter
from samrs_tpu_torch.generate.fleet import run_fleet
from samrs_tpu_torch.generate.semantic import SemanticGenerator, generate_semantic
from samrs_tpu_torch.sam import SamPredictor, sam_forward_batched
from test_torch_port_generate import (TOL, _assert_records_match, _fp32_matmuls,  # noqa: F401
                                      _mask_iou, tiny)

SIZES = ((60, 80), (72, 56))  # two image shapes (H, W); the tiny model's image_size is 96
# six images, both shapes inside the first four (the first encode batch)
ORDER = (0, 0, 1, 0, 1, 0)
FLEET_LIMIT_S = 120  # a run_fleet that has not ended by then hangs


def _dior_xml(rng, h, w, n):
    objs = []
    for _ in range(n):
        x0, y0 = rng.uniform(0, w - 12), rng.uniform(0, h - 12)
        x1, y1 = min(x0 + rng.uniform(8, 40), w - 1), min(y0 + rng.uniform(8, 40), h - 1)
        name = mapping.CLASS_SETS["dior"][int(rng.integers(0, 20))]
        objs.append(f"<object><name>{name}</name><bndbox><xmin>{x0:.1f}</xmin>"
                    f"<ymin>{y0:.1f}</ymin><xmax>{x1:.1f}</xmax><ymax>{y1:.1f}</ymax>"
                    "</bndbox></object>")
    return "<annotation>" + "".join(objs) + "</annotation>"


@pytest.fixture(scope="module")
def mini_set(tmp_path_factory):
    """Six DIOR images of two shapes with 2-5 boxes each -> (image dir,
    annotation dir, names)."""
    root = tmp_path_factory.mktemp("fleet_set")
    img_dir, ann_dir = root / "images", root / "anns"
    img_dir.mkdir()
    ann_dir.mkdir()
    rng = np.random.default_rng(21)
    names = []
    for i, s in enumerate(ORDER):
        h, w = SIZES[s]
        name = f"im{i}"
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(image).save(img_dir / f"{name}.png")
        (ann_dir / f"{name}.xml").write_text(_dior_xml(rng, h, w, int(rng.integers(2, 6))))
        names.append(name)
    return str(img_dir), str(ann_dir), names


def _cfg(mini_set, save_dir, **kw):
    img_dir, ann_dir, _ = mini_set
    kw.setdefault("device", "cpu")
    return GenerateConfig(dataset="dior", image_dir=img_dir, ann_dir=ann_dir,
                          save_dir=str(save_dir), box_buckets=(4, 16), **kw)


def _with_limit(fn, limit=FLEET_LIMIT_S):
    """fn() in a daemon thread; fails the test if it has not ended in
    `limit` s.  Returns ("value", result) or ("error", exception)."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - returned to the test
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"run_fleet did not end within {limit} s"
    return next(iter(out.items()))


def test_painter_matches_jax():
    """Host painting, the device fold over padded chunks and its gray /
    colour maps, byte for byte against the JAX painter."""
    rng = np.random.default_rng(5)
    masks = rng.random((7, 20, 30)) > 0.7
    labels = rng.integers(0, 20, 7).astype(np.int32)
    for got, want in zip(painter.paint_semantic(masks, labels, (20, 30)),
                         jax_paint_semantic(masks, labels, (20, 30))):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))
    chunks = [(0, masks[:3]), (3, masks[3:6]), (6, masks[6:])]
    got = painter.paint_semantic_device(((b, torch.from_numpy(c)) for b, c in chunks),
                                        labels, (20, 30))
    want = jax_paint_semantic_device(((b, jnp.asarray(c)) for b, c in chunks), labels, (20, 30))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got[0], painter.paint_semantic(masks, labels, (20, 30))[0])
    # a chunk padded to 4 with 2 live masks: the padding is ignored
    cover = torch.full((20, 30), -1, dtype=torch.int32)
    padded = np.concatenate([masks[:2], np.ones((2, 20, 30), bool)])
    got = painter.update_cover(cover, torch.from_numpy(padded), 5, 2)
    want = jax_update_cover(jnp.asarray(cover.numpy()), jnp.asarray(padded), jnp.int32(5),
                            jnp.int32(2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*SIZES[s], 3), dtype=np.uint8) for s in (0, 1, 0)]


def test_encode_images_matches_jax_and_set_image(tiny):
    """Three images of two sizes in one encoder pass: features against JAX's
    encode_images and against the port's set_image image by image."""
    jmodel, jvars, model = tiny
    images = _images(8)
    want = JaxPredictor(jmodel, jvars).encode_images(images)
    p = SamPredictor(model)
    got = p.encode_images(images)
    assert len(got) == len(want) == 3
    for image, (feats, orig, inp), (jfeats, jorig, jinp) in zip(images, got, want):
        assert tuple(feats.shape) == jfeats.shape == (1, 6, 6, 32)
        assert (orig, inp) == (tuple(jorig), tuple(jinp))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=TOL, rtol=TOL)
        p.set_image(image)
        assert (p.original_size, p.input_size) == (orig, inp)
        np.testing.assert_allclose(feats.numpy(), p.features.numpy(), atol=TOL, rtol=TOL)


def test_upscale_chunk_and_packed_fetch_match_jax(tiny):
    """A chunk of low-res logits to full-resolution logits and thresholded
    masks on the device, then fetched bit-packed, against JAX's."""
    jmodel, jvars, model = tiny
    image = _images(11)[1]
    boxes = np.array([[2, 3, 40, 50], [10, 5, 50, 70], [0, 0, 55, 71]], np.float32)
    jp = JaxPredictor(jmodel, jvars, buckets=(4, 16))
    jp.set_image(image)
    jlow, _ = jp.predict_boxes_lowres(boxes)
    p = SamPredictor(model, buckets=(4, 16))
    p.set_image(image)
    low, _ = p.predict_boxes_lowres(boxes)
    logits = p.upscale_chunk(low[:3], binarize=False)
    assert tuple(logits.shape) == (3, 1, *image.shape[:2])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jp.upscale_chunk(jlow[:3], False)),
                               atol=1e-3, rtol=1e-3)
    masks = p.fetch_masks_packed(p.upscale_chunk(low[:3]))
    want = jp.fetch_masks_packed(jp.upscale_chunk(jlow[:3]))
    assert masks.dtype == np.bool_ and masks.shape == want.shape == (3, 1, *image.shape[:2])
    np.testing.assert_array_equal(masks, (logits > model.cfg.mask_threshold).numpy())
    for g, w in zip(masks.reshape(3, -1), want.reshape(3, -1)):
        assert _mask_iou(g, w) >= 0.999


def test_sam_forward_batched_matches_jax(tiny):
    """Box, point and mask-input records in one batch."""
    jmodel, jvars, model = tiny
    images = _images(9)
    rng = np.random.default_rng(10)
    records = [
        {"image": images[0], "boxes": np.array([[2, 3, 40, 50], [10, 5, 70, 55]], np.float32)},
        {"image": images[1].transpose(2, 0, 1), "point_coords": np.array([[20, 30], [40, 10]]),
         "point_labels": np.array([1, 0])},
        {"image": images[2], "point_coords": np.array([[30, 25]]), "point_labels": np.array([1]),
         "mask_inputs": rng.normal(size=(1, 24, 24)).astype(np.float32)},
    ]
    want = jax_sam_forward_batched(JaxPredictor(jmodel, jvars, buckets=(4, 16)), records)
    got = sam_forward_batched(SamPredictor(model, buckets=(4, 16)), records)
    for g, w, rec in zip(got, want, records):
        n = len(rec.get("boxes", [0]))
        h, w_ = (rec["image"].shape[1:] if rec["image"].shape[0] == 3 else rec["image"].shape[:2])
        assert g["masks"].shape == np.asarray(w["masks"]).shape == (n, 1, h, w_)
        np.testing.assert_allclose(g["low_res_logits"], np.asarray(w["low_res_logits"]),
                                   atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(g["iou_predictions"], np.asarray(w["iou_predictions"]),
                                   atol=1e-3, rtol=1e-3)
        for gm, wm in zip(g["masks"].reshape(n, -1), np.asarray(w["masks"]).reshape(n, -1)):
            assert _mask_iou(gm, wm.astype(bool)) >= 0.999


def _read(save_dir, kind, name):
    if kind == "ins":
        with open(os.path.join(save_dir, "ins", name + ".pkl"), "rb") as f:
            return pickle.load(f)
    with Image.open(os.path.join(save_dir, kind, name + ".png")) as im:
        return np.asarray(im)


def test_run_fleet_matches_generate_semantic(tiny, mini_set, tmp_path):
    """run_fleet on the CPU against JAX's generate_semantic and the port's
    one-image driver: every image written, records and gray maps within the
    generate tests' rules; the first encode batch splits by shape."""
    jmodel, jvars, model = tiny
    img_dir, ann_dir, names = mini_set
    stats = {}
    kind, n = _with_limit(lambda: run_fleet(_cfg(mini_set, tmp_path / "fleet"), model=model,
                                            stats=stats))
    assert kind == "value" and n == len(names)
    assert stats["total"] == 6 and stats["per_device"] == [6]
    # batches of 4 then 2, each split by shape: (3 of 60x80, 1 of 72x56), (1, 1)
    assert stats["encode_batches"] == [3, 1, 1, 1]
    assert 0 < stats["overlap"] <= 1 and stats["balance"] == 1.0
    jcfg = JaxGenerateConfig(dataset="dior", image_dir=img_dir, ann_dir=ann_dir,
                             save_dir=str(tmp_path / "jax"))
    assert jax_generate_semantic(jcfg, predictor=JaxPredictor(jmodel, jvars, buckets=(4, 16))) == 6
    assert generate_semantic(_cfg(mini_set, tmp_path / "one"),
                             predictor=SamPredictor(model, buckets=(4, 16))) == 6
    for name in names:
        gray = _read(tmp_path / "fleet", "gray", name)
        np.testing.assert_array_equal(_read(tmp_path / "fleet", "color", name),
                                      mapping.PALETTE[gray])
        records = _read(tmp_path / "fleet", "ins", name)
        masks = np.stack([rle_decode(r["mask"]) for r in records]).astype(bool)
        cover = np.where(masks.any(0), len(masks) - 1 - masks[::-1].argmax(0), -1)
        labels = np.array([r["label"] for r in records])
        np.testing.assert_array_equal(gray, np.where(cover >= 0, labels[cover], 255))
        for other in ("jax", "one"):
            assert (gray == _read(tmp_path / other, "gray", name)).mean() >= 0.999
            _assert_records_match(records, _read(tmp_path / other, "ins", name))


def test_shards_are_disjoint_and_cover_the_set(tiny, mini_set, tmp_path):
    _, _, model = tiny
    written = []
    for index in range(2):
        save_dir = tmp_path / f"shard{index}"
        kind, n = _with_limit(lambda: run_fleet(
            _cfg(mini_set, save_dir, shard_index=index, shard_count=2), model=model))
        assert kind == "value" and n == 3
        written.append({f[:-4] for f in os.listdir(save_dir / "ins")})
    assert not written[0] & written[1]
    assert written[0] | written[1] == set(mini_set[2])


def test_copy_to_makes_an_independent_equal_model(tiny):
    """The copy every further device gets: equal parameters and buffers, no
    storage shared with the original, equal features from encode_images."""
    _, _, model = tiny
    copy = fleet.copy_to(model, torch.device("cpu"))
    assert copy is not model and not copy.training
    ptrs = {t.untyped_storage().data_ptr() for t in model.state_dict().values()}
    want = model.state_dict()
    got = copy.state_dict()
    assert got.keys() == want.keys()
    for key, t in got.items():
        assert t.device.type == "cpu", key
        assert torch.equal(t, want[key]), key
        assert t.untyped_storage().data_ptr() not in ptrs, key
    images = _images(12)
    for (g, g_orig, g_inp), (w, w_orig, w_inp) in zip(SamPredictor(copy).encode_images(images),
                                                      SamPredictor(model).encode_images(images)):
        assert (g_orig, g_inp) == (w_orig, w_inp)
        assert torch.equal(g, w)


def test_run_fleet_needs_a_card_by_default(tiny, mini_set, tmp_path):
    cfg = _cfg(mini_set, tmp_path, device="cuda")
    assert GenerateConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        run_fleet(cfg, model=tiny[2])
    img_dir, ann_dir, _ = mini_set
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        fleet.main(["--image-dir", img_dir, "--ann-dir", ann_dir, "--save-dir", str(tmp_path)])


def test_writer_failure_raises(tiny, mini_set, tmp_path):
    """Every image's gray PNG path is taken by a directory, so no write can
    succeed: run_fleet raises the writer's error."""
    for name in mini_set[2]:
        os.makedirs(tmp_path / "gray" / f"{name}.png")
    kind, err = _with_limit(lambda: run_fleet(_cfg(mini_set, tmp_path), model=tiny[2]))
    assert kind == "error" and isinstance(err, OSError)


def test_worker_exception_raises(tiny, mini_set, tmp_path, monkeypatch):
    """A worker that raises on its second image, with 24 images behind a
    queue of 8 and 8 decodes in flight: the feed stops and the error reaches
    the caller."""
    calls = []
    real = SemanticGenerator.process_encoded

    def flaky(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("worker failed on purpose")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(SemanticGenerator, "process_encoded", flaky)
    kind, err = _with_limit(lambda: run_fleet(_cfg(mini_set, tmp_path), image_list=mini_set[2] * 4,
                                              model=tiny[2]))
    assert kind == "error" and isinstance(err, ValueError) and "on purpose" in str(err)
    assert len(calls) == 2
