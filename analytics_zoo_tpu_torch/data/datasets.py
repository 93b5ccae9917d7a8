"""Readers copied from the JAX package's ``data/datasets.py`` (numpy
only): the ml-1m ``ratings.dat`` parser, its MovieLens-1M-shaped
synthetic stand-in, and both as an Estimator-ready ``FeatureSet``; the
Pascal VOC (XML per image) and COCO (instances JSON) detection
annotation readers; the folder-per-class text corpus reader and its
synthetic stand-in.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["read_movielens_1m", "generate_movielens_like",
           "movielens_featureset", "VOC_CLASSES", "read_pascal_voc",
           "read_coco", "read_text_folder", "generate_text_classification"]


def read_movielens_1m(path: str) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """Parse ml-1m ``ratings.dat`` (``user::item::rating::ts``) ->
    (user_ids, item_ids, ratings), 1-based ids."""
    f = os.path.join(path, "ratings.dat") if os.path.isdir(path) else path
    users, items, ratings = [], [], []
    with open(f) as fh:
        for line in fh:
            parts = line.strip().split("::")
            if len(parts) < 3:
                continue
            users.append(int(parts[0]))
            items.append(int(parts[1]))
            ratings.append(float(parts[2]))
    return (np.asarray(users, np.int64), np.asarray(items, np.int64),
            np.asarray(ratings, np.float32))


def generate_movielens_like(n_users: int = 6040, n_items: int = 3706,
                            ratings_per_user: int = 20, latent: int = 8,
                            seed: int = 0):
    """MovieLens-1M-shaped synthetic ratings with a low-rank preference
    structure (learnable): ``ratings_per_user`` ratings for each user,
    1-based ids, ratings 1..5.  Bit-identical to the JAX package's."""
    rs = np.random.RandomState(seed)
    zu = rs.randn(n_users + 1, latent)
    zi = rs.randn(n_items + 1, latent)
    users, items, ratings = [], [], []
    for u in range(1, n_users + 1):
        picked = rs.randint(1, n_items + 1, ratings_per_user)
        score = (zu[u] * zi[picked]).sum(axis=1)
        r = np.clip(np.round(3 + score), 1, 5)
        users.extend([u] * ratings_per_user)
        items.extend(picked.tolist())
        ratings.extend(r.tolist())
    return (np.asarray(users, np.int64), np.asarray(items, np.int64),
            np.asarray(ratings, np.float32))


def movielens_featureset(path: Optional[str] = None,
                         cache_level: Optional[str] = None, **generate_kw):
    """Ratings as an Estimator-ready ``FeatureSet``: arrays
    ``(user[:, None], item[:, None], rating)`` — the NeuralCF input
    layout.  Reads ml-1m from ``path`` when given, else generates the
    synthetic stand-in (``generate_movielens_like(**generate_kw)``).
    ``cache_level="DEVICE"`` holds the set on the device."""
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet

    users, items, ratings = (read_movielens_1m(path) if path
                             else generate_movielens_like(**generate_kw))
    return FeatureSet.from_ndarrays(
        [users[:, None].astype(np.int32), items[:, None].astype(np.int32)],
        ratings, cache_level=cache_level)


# ---------------------------------------------------------------------------
# Pascal VOC (an XML annotation per image)
# ---------------------------------------------------------------------------

VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")


def read_pascal_voc(annotations_dir: str,
                    class_names: Sequence[str] = VOC_CLASSES,
                    keep_difficult: bool = False) -> List[Dict]:
    """Parse VOC XML annotations -> list of records
    {file, width, height, bboxes (N,4 pixels x1y1x2y2), labels (N,
    1-based), difficult (N,)}."""
    cls_idx = {c: i + 1 for i, c in enumerate(class_names)}
    out = []
    for fn in sorted(os.listdir(annotations_dir)):
        if not fn.endswith(".xml"):
            continue
        root = ET.parse(os.path.join(annotations_dir, fn)).getroot()
        size = root.find("size")
        boxes, labels, difficult = [], [], []
        for obj in root.findall("object"):
            name = obj.findtext("name")
            if name not in cls_idx:
                continue
            diff = int(obj.findtext("difficult") or 0)
            if diff and not keep_difficult:
                continue
            bb = obj.find("bndbox")
            boxes.append([float(bb.findtext("xmin")),
                          float(bb.findtext("ymin")),
                          float(bb.findtext("xmax")),
                          float(bb.findtext("ymax"))])
            labels.append(cls_idx[name])
            difficult.append(diff)
        out.append({
            "file": root.findtext("filename") or fn.replace(".xml", ".jpg"),
            "width": int(size.findtext("width")) if size is not None else 0,
            "height": int(size.findtext("height")) if size is not None
            else 0,
            "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "difficult": np.asarray(difficult, np.int64),
        })
    return out


# ---------------------------------------------------------------------------
# COCO (an instances JSON)
# ---------------------------------------------------------------------------

def read_coco(annotation_file: str) -> List[Dict]:
    """Parse a COCO instances JSON -> per-image records
    {file, width, height, bboxes (N,4 pixels x1y1x2y2), labels (N,)}."""
    with open(annotation_file) as f:
        blob = json.load(f)
    images = {im["id"]: im for im in blob.get("images", [])}
    recs = {im_id: {"file": im.get("file_name", ""),
                    "width": im.get("width", 0),
                    "height": im.get("height", 0),
                    "bboxes": [], "labels": []}
            for im_id, im in images.items()}
    for ann in blob.get("annotations", []):
        rec = recs.get(ann["image_id"])
        if rec is None:
            continue
        x, y, w, h = ann["bbox"]                   # coco xywh
        rec["bboxes"].append([x, y, x + w, y + h])
        rec["labels"].append(ann["category_id"])
    out = []
    for rec in recs.values():
        rec["bboxes"] = np.asarray(rec["bboxes"], np.float32).reshape(-1, 4)
        rec["labels"] = np.asarray(rec["labels"], np.int64)
        out.append(rec)
    return out


def read_text_folder(path: str, encoding: str = "utf-8"
                     ) -> Tuple[List[str], np.ndarray, Dict[str, int]]:
    """Folder-per-class corpus -> (texts, labels (0-based), class_map)."""
    classes = sorted(d for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d)))
    class_map = {c: i for i, c in enumerate(classes)}
    texts, labels = [], []
    for c in classes:
        cdir = os.path.join(path, c)
        for fn in sorted(os.listdir(cdir)):
            fp = os.path.join(cdir, fn)
            if not os.path.isfile(fp):
                continue
            with open(fp, encoding=encoding, errors="replace") as f:
                texts.append(f.read())
            labels.append(class_map[c])
    return texts, np.asarray(labels, np.int64), class_map


def generate_text_classification(n_classes: int = 4, per_class: int = 50,
                                 seed: int = 0
                                 ) -> Tuple[List[str], np.ndarray]:
    """Synthetic folder-corpus stand-in: each class has a distinctive
    keyword vocabulary, so classifiers can actually learn."""
    rs = np.random.RandomState(seed)
    common = ["the", "a", "of", "and", "to", "in", "it", "is"]
    themes = [[f"w{c}_{k}" for k in range(12)] for c in range(n_classes)]
    texts, labels = [], []
    for c in range(n_classes):
        for _ in range(per_class):
            n = rs.randint(12, 30)
            words = [
                themes[c][rs.randint(len(themes[c]))]
                if rs.rand() < 0.55 else common[rs.randint(len(common))]
                for _ in range(n)]
            texts.append(" ".join(words))
            labels.append(c)
    return texts, np.asarray(labels, np.int64)
