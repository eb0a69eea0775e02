"""Annotation loaders for DIOR (VOC XML), HRSC (XML), DOTA and FAIR1M
(txt), the port's copy of samrs_tpu/data/loaders.py: one ``Annotation`` of
stacked (N, ...) arrays per image, with the reference's ``error=1`` flag
for an empty annotation.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from samrs_tpu_torch.data.mapping import NAME_TO_INDEX
from samrs_tpu_torch.geometry.obb import obb2poly


@dataclass
class Annotation:
    """Stacked per-image annotations.  Arrays are empty (0, ...) when absent."""

    hboxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    polys: np.ndarray = field(default_factory=lambda: np.zeros((0, 4, 2), np.float32))
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    labels: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))
    class_names: List[str] = field(default_factory=list)
    error: int = 0

    @property
    def num_instances(self) -> int:
        return max(self.hboxes.shape[0], self.polys.shape[0])


def load_dior(img_name: str, ann_path: str) -> Annotation:
    """DIOR VOC-XML horizontal boxes (loaddata.py:10-38).

    Reads `{img_name}.xml`; `<robndbox>` is the fallback tag some files use.
    """
    tree = ET.parse(osp.join(ann_path, f"{img_name}.xml"))
    cls2lbl = NAME_TO_INDEX["dior"]
    hboxes, points, labels, names = [], [], [], []
    for obj in tree.getroot().findall("object"):
        category = str(obj.find("name").text.lower())
        bnd = obj.find("bndbox")
        if bnd is None:
            bnd = obj.find("robndbox")
        x0, y0 = float(bnd.find("xmin").text), float(bnd.find("ymin").text)
        x1, y1 = float(bnd.find("xmax").text), float(bnd.find("ymax").text)
        hboxes.append((x0, y0, x1, y1))
        points.append(((x0 + x1) / 2, (y0 + y1) / 2))
        labels.append(cls2lbl[category])
        names.append(category)
    if not hboxes:
        return Annotation(error=1)
    return Annotation(
        hboxes=np.asarray(hboxes, np.float32),
        points=np.asarray(points, np.float32),
        labels=np.asarray(labels, np.int32),
        class_names=names,
    )


def load_hrsc(img_name: str, ann_path: str) -> Annotation:
    """HRSC2016 XML: hbox + rbox(cx,cy,w,h,ang) + seg color + center point
    (loaddata.py:41-102).  rbox -> polygon via le90 obb2poly; single class 0;
    a malformed seg_color sets error=1 as in the reference.
    """
    tree = ET.parse(osp.join(ann_path, f"{img_name}.xml"))
    hboxes, polys, colors, points = [], [], [], []
    error = 0
    for obj in tree.getroot().findall("HRSC_Objects/HRSC_Object"):
        hboxes.append(
            (
                float(obj.find("box_xmin").text),
                float(obj.find("box_ymin").text),
                float(obj.find("box_xmax").text),
                float(obj.find("box_ymax").text),
            )
        )
        cx, cy = float(obj.find("mbox_cx").text), float(obj.find("mbox_cy").text)
        obb = np.array(
            [[cx, cy, float(obj.find("mbox_w").text), float(obj.find("mbox_h").text),
              float(obj.find("mbox_ang").text)]],
            np.float32,
        )
        polys.append(obb2poly(obb).reshape(4, 2))
        color_list = obj.find("seg_color").text.split(",")
        if len(color_list) != 3:
            error = 1
            colors.append((0, 0, 0))
        else:
            colors.append(tuple(int(c) for c in color_list))
        points.append((cx, cy))
    if not hboxes or not polys:
        return Annotation(error=1)
    return Annotation(
        hboxes=np.asarray(hboxes, np.float32),
        polys=np.asarray(polys, np.float32),
        colors=np.asarray(colors, np.uint8),
        points=np.asarray(points, np.float32),
        labels=np.zeros(len(hboxes), np.int32),
        error=error,
    )


def load_dota(img_name: str, ann_path: str) -> Annotation:
    """DOTA-format txt: 8 poly coords + class name + class index per line
    (loaddata.py:104-132).  Also used for FAIR1M after XML->txt conversion.

    Matches the reference's hbox derivation: corners 1 and 3 of the polygon
    (NOT the min/max envelope — that is computed later by the rhbox drivers).
    """
    with open(osp.join(ann_path, f"{img_name}.txt")) as f:
        lines = [ln.strip().split() for ln in f if ln.strip()]
    if not lines:
        return Annotation(error=1)
    coords = np.asarray([[float(v) for v in ln[:8]] for ln in lines], np.float32)
    names = [ln[8] for ln in lines]
    labels = np.asarray([int(ln[9]) for ln in lines], np.int32)
    polys = coords.reshape(-1, 4, 2)
    hboxes = np.concatenate([polys[:, 0], polys[:, 2]], axis=1)
    points = (polys[:, 0] + polys[:, 2]) / 2.0
    return Annotation(
        hboxes=hboxes.astype(np.float32),
        polys=polys,
        points=points.astype(np.float32),
        labels=labels,
        class_names=names,
    )


LOADERS = {"dior": load_dior, "hrsc": load_hrsc, "dota": load_dota, "fair1m": load_dota}
