"""The PyTorch port's image pipeline (``data/image.py``), the VOC / COCO
readers and image records in ClusterServing against the JAX package on
the CPU, where ``cv2`` is installed and the JAX side uses it.

Every preprocessor runs on the same seeded inputs in both packages, each
from its own ``np.random.RandomState(seed)``, and both generators must
end in the same state (the same draws in the same order).  Tolerances,
with their reasons:

- transforms that move or mix pixels without resizing (crops, flips,
  expansion, normalisation, jitter) and the seeded ``RandomSampler``:
  bit-equal images, boxes and labels;
- resizing a uint8 image: within one level of ``cv2.resize`` (the port
  follows OpenCV's fixed-point weights and its vectorised column pass;
  OpenCV's scalar tail rounds some pixels of some widths the other way)
  and bit-equal at SSD's 375x500 -> 300x300; a float32 image within
  1e-5 of its largest value (OpenCV's vector code rounds the two-tap
  sums differently); nearest-neighbour resizing is exact;
- the HSV round trip of ``ImageHue``: BGR -> HSV exact (OpenCV's integer
  tables), HSV -> BGR within one level (float32 sectors, rounded half to
  even; OpenCV's vector path fuses some products), so the hue-shifted
  image within one level;
- ClusterServing: the same top-2 indices and values within 1e-5 (f32
  sums in other orders) for raw-pixel and png-file records, whose
  preprocessing (an exact 2x resize, a crop) gives both packages the
  same pixels.
"""

import importlib
import json
import sys
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import datasets as jds
from analytics_zoo_tpu.data import image as ji

from analytics_zoo_tpu_torch.data import datasets as tds
from analytics_zoo_tpu_torch.data import image as ti

TIMEOUT = 60.0


def _feat_pair(img, **extra):
    return (ji.ImageFeature(image=img.copy(), **{k: np.copy(v) for k, v in
                                                 extra.items()}),
            ti.ImageFeature(image=img.copy(), **{k: np.copy(v) for k, v in
                                                 extra.items()}))


def _apply_pair(name, args, img, seed=0, **extra):
    """Run the named preprocessor of both packages on copies of one
    feature, each from RandomState(seed); the two features and whether
    the generators ended in the same state."""
    jf, tf = _feat_pair(img, **extra)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    jf = getattr(ji, name)(*args).apply(jf, jr)
    tf = getattr(ti, name)(*args).apply(tf, tr)
    same_draws = all(np.array_equal(a, b) if isinstance(a, np.ndarray)
                     else a == b for a, b in zip(jr.get_state(),
                                                 tr.get_state()))
    return jf, tf, same_draws


def _assert_features(jf, tf, levels=0, rel=0.0):
    assert set(jf) == set(tf), (set(jf), set(tf))
    for k in jf:
        a, b = jf[k], tf[k]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape,
                                                              b.shape)
            if k in ("image", "sample", "floats") and (levels or rel):
                if a.dtype == np.uint8:
                    assert np.abs(a.astype(int) - b).max() <= levels, k
                else:
                    tol = rel * max(1.0, float(np.abs(a).max()))
                    np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                               err_msg=k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            assert a == b, (k, a, b)


def _img(h, w, seed=0, dtype=np.uint8):
    a = np.random.RandomState(seed).randint(0, 256, (h, w, 3))
    return a.astype(dtype)


EXACT_CASES = [
    ("ImageCenterCrop", (20, 24)),
    ("ImageRandomCrop", (20, 24)),
    ("ImageHFlip", ()),
    ("ImageRandomHFlip", (0.5,)),
    ("ImageChannelOrder", ()),
    ("ImageBrightness", (-32.0, 32.0)),
    ("ImageContrast", (0.5, 1.5)),
    ("ImageSaturation", (0.5, 1.5)),
    ("ImageColorJitter", ()),
    ("ImageExpand", ((104.0, 117.0, 123.0), 3.0)),
    ("ImageChannelNormalize", (123.0, 117.0, 104.0, 58.0, 57.0, 57.5)),
    ("ImageSetToSample", ()),
    ("ImageMatToFloats", ()),
    ("ImageFeatureToTensor", ()),
    ("ImageFiller", (0.1, 0.2, 0.6, 0.7, 7.0)),
    ("ImageFixedCrop", (0.1, 0.2, 0.7, 0.9)),
    ("ImageMirror", ()),
    ("ImageChannelScaledNormalizer", (123.0, 117.0, 104.0, 0.017)),
    ("RoiNormalize", ()),
    ("RoiHFlip", (False,)),
    ("RowToImageFeature", ()),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,args", EXACT_CASES)
def test_preprocessors_bit_equal_to_jax(name, args, seed):
    """Transforms that do not resize: the same draws, bit-equal
    features (images, boxes, labels and what they record)."""
    img = _img(37, 45, seed)
    boxes = np.array([[3.0, 4.0, 20.0, 30.0], [10.0, 1.0, 44.0, 36.0]],
                     np.float32)
    jf, tf, same = _apply_pair(name, args, img, seed, bboxes=boxes,
                               label=np.array([3, 7]))
    assert same
    _assert_features(jf, tf)


def test_random_preprocessing_and_pixel_bytes_match_jax():
    img = _img(12, 10)
    for seed in range(6):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        jf = ji.ImageRandomPreprocessing(ji.ImageBrightness(-9, 9), 0.5)\
            .apply(ji.ImageFeature(image=img.copy()), jr)
        tf = ti.ImageRandomPreprocessing(ti.ImageBrightness(-9, 9), 0.5)\
            .apply(ti.ImageFeature(image=img.copy()), tr)
        _assert_features(jf, tf)
        assert jr.rand() == tr.rand()
    raw = img.tobytes()
    feat = dict(bytes=raw, height=12, width=10, nChannels=3)
    jf = ji.ImagePixelBytesToMat().apply(ji.ImageFeature(feat), None)
    tf = ti.ImagePixelBytesToMat().apply(ti.ImageFeature(feat), None)
    _assert_features(jf, tf)
    row = {"data": img, "origin": "x.png"}
    _assert_features(ji.RowToImageFeature.from_row(row),
                     ti.RowToImageFeature.from_row(row))


RESIZE_CASES = [
    ("ImageResize", (30, 40)),
    ("ImageResize", (50, 23, "nearest")),
    ("BufferedImageResize", (24, 61)),
    ("ImageAspectScale", (30, 1000)),
    ("ImageAspectScale", (64, 70, 8)),
    ("ImageRandomAspectScale", ((20, 30, 52),)),
    ("ImageRandomResize", (20, 50)),
    ("ImageRandomCropper", (50, 60)),
    ("ImageRandomCropper", (20, 25, False)),
    ("RoiResize", (300, 300)),
    ("RoiResize", (41, 27)),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,args", RESIZE_CASES)
def test_resizing_preprocessors_match_cv2(name, args, seed, dtype):
    """Resizing transforms against the JAX ones on cv2: uint8 within one
    level, float32 within 1e-5 of the largest value, the same draws."""
    img = _img(47, 53, seed, dtype)
    if dtype == np.float32:
        img = img * np.float32(1.37)
    boxes = np.array([[3.0, 4.0, 20.0, 30.0]], np.float32)
    jf, tf, same = _apply_pair(name, args, img, seed, bboxes=boxes)
    assert same
    _assert_features(jf, tf, levels=1, rel=1e-5)


@pytest.mark.parametrize("hw,out", [((375, 500), (300, 300)),
                                    ((37, 50), (64, 81)),
                                    ((20, 30), (10, 15)),
                                    ((5, 9), (17, 3)),
                                    ((64, 64), (64, 64))])
def test_resize_against_cv2(hw, out):
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    size = (out[1], out[0])
    want = cv2.resize(img, size)
    got = ti.resize(img, size)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    if hw == (375, 500) or out == hw or 2 * out[0] == hw[0]:
        np.testing.assert_array_equal(got, want)
    gray = img[..., 0]
    assert np.abs(ti.resize(gray, size).astype(int)
                  - cv2.resize(gray, size)).max() <= 1
    f = img.astype(np.float32) * np.float32(0.77)
    np.testing.assert_allclose(ti.resize(f, size), cv2.resize(f, size),
                               rtol=0, atol=1e-5 * float(f.max()))
    np.testing.assert_array_equal(
        ti.resize(img, size, "nearest"),
        cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


def test_hsv_against_cv2():
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (64, 80, 3)).astype(np.uint8)
    img[:8] = img[:8, :, :1]                  # grey rows (S = 0)
    np.testing.assert_array_equal(ti.bgr_to_hsv(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    grid = np.stack(np.meshgrid(np.arange(180), np.arange(0, 256, 5),
                                np.arange(0, 256, 5), indexing="ij"),
                    -1).reshape(-1, 1, 3).astype(np.uint8)
    got = ti.hsv_to_bgr(grid)
    want = cv2.cvtColor(grid, cv2.COLOR_HSV2BGR)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got == want).mean() > 0.999


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_image_hue_matches_jax(seed):
    img = _img(30, 40, seed).astype(np.float32)
    jf, tf, same = _apply_pair("ImageHue", (-18.0, 18.0), img, seed)
    assert same
    _assert_features(jf, tf, levels=1, rel=1.0 / 255.0)
    assert np.abs(jf.image - tf.image).max() <= 1.0


def _ssd_chain(mod):
    return (mod.RandomSampler() | mod.RoiHFlip() | mod.RoiResize(300, 300)
            | mod.RoiNormalize()
            | mod.ImageChannelNormalize(123.0, 117.0, 104.0))


@pytest.mark.parametrize("seed", range(8))
def test_random_sampler_crops_bit_equal(seed):
    """SSD's RandomSampler (the retry loop, integer crops, the boxes kept
    by their centres) draws and crops as the JAX one does, bit for bit;
    the whole SSD augmentation chain then gives the same boxes and
    labels, and the image within one level (the uint8 resize)."""
    rs = np.random.RandomState(100 + seed)
    img = rs.randint(0, 256, (375, 500, 3)).astype(np.uint8)
    n = 1 + seed % 4
    xy = rs.uniform(0, 300, (n, 2))
    wh = rs.uniform(40, 200, (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [500, 375])],
                           1).astype(np.float32)
    labels = rs.randint(1, 21, n)
    jf, tf, same = _apply_pair("RandomSampler", (), img, seed,
                               bboxes=boxes, label=labels)
    assert same
    _assert_features(jf, tf)
    jf, tf = _feat_pair(img, bboxes=boxes, label=labels)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    jf = _ssd_chain(ji).apply(jf, jr)
    tf = _ssd_chain(ti).apply(tf, tr)
    np.testing.assert_array_equal(tf["bboxes"], jf["bboxes"])
    np.testing.assert_array_equal(tf["label"], jf["label"])
    assert np.abs(tf.image - jf.image).max() <= 1.0


def test_image_set_to_arrays_matches_jax():
    """``from_arrays`` + ``transform`` + ``to_arrays`` with per-index
    seeds (any worker count), ``get_image`` and ``to_feature_set``."""
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (rs.randint(30, 40), rs.randint(30, 40), 3))
            .astype(np.uint8) for _ in range(40)]
    labels = list(rs.randint(0, 5, 40))

    def chain(m):
        return (m.ImageRandomCrop(28, 28) | m.ImageRandomHFlip()
                | m.ImageColorJitter() | m.ImageSetToSample())

    jset = ji.ImageSet.from_arrays(imgs, labels).transform(chain(ji))
    tset = ti.ImageSet.from_arrays(imgs, labels).transform(chain(ti))
    jx, jy = jset.to_arrays(epoch_seed=3)
    for workers in (1, 4):
        tx, ty = tset.to_arrays(epoch_seed=3, num_workers=workers)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tset.get_image(5), jset.get_image(5))
    assert len(tset) == len(jset) == 40
    fs = tset.to_feature_set()
    from analytics_zoo_tpu_torch.data import FeatureSet

    assert isinstance(fs, FeatureSet) and fs.size == 40
    nolabel = ti.ImageSet.from_arrays(imgs[:2])
    nolabel.features[0]["label"] = 1
    with pytest.raises(ValueError, match="no label"):
        nolabel.transform(ti.ImageCenterCrop(8, 8)).to_arrays()


def test_image_set_read_matches_jax(tmp_path):
    rs = np.random.RandomState(1)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            cv2.imwrite(str(tmp_path / cls / f"{i}.png"),
                        rs.randint(0, 256, (9, 11, 3)).astype(np.uint8))
    for kw in ({}, {"with_label": True},
               {"with_label": True, "one_based_label": False,
                "num_shards": 2, "shard_index": 1}):
        js = ji.ImageSet.read(str(tmp_path), **kw)
        ts = ti.ImageSet.read(str(tmp_path), **kw)
        assert js.label_map == ts.label_map
        assert len(js) == len(ts)
        for a, b in zip(js.features, ts.features):
            _assert_features(a, b)


def _hide_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_without_cv2_raises_typed_error_naming_cv2(monkeypatch, tmp_path):
    """With ``cv2`` hidden, reading files and decoding bytes raise
    ``Cv2Unavailable`` (an ImportError) naming cv2, and resizing and
    the HSV round trip still run (the port's own code)."""
    cv2.imwrite(str(tmp_path / "a.png"), _img(5, 6))
    raw = (tmp_path / "a.png").read_bytes()
    _hide_cv2(monkeypatch)
    with pytest.raises(ti.Cv2Unavailable, match="cv2"):
        ti.require_cv2("x")
    with pytest.raises(ImportError, match="cv2"):
        ti.ImageSet.read(str(tmp_path))
    with pytest.raises(ti.Cv2Unavailable, match="cv2"):
        ti.ImageBytesToMat().apply(ti.ImageFeature(bytes=raw), None)
    from analytics_zoo_tpu_torch.deploy import decode_image, encode_image
    from analytics_zoo_tpu_torch.models.objectdetection import (
        draw_detections)

    with pytest.raises(ti.Cv2Unavailable, match="cv2"):
        decode_image(encode_image(str(tmp_path / "a.png")))
    with pytest.raises(ti.Cv2Unavailable, match="cv2"):
        draw_detections(_img(5, 6), np.zeros((0, 4)), [], [])
    out = ti.ImageHue().apply(ti.ImageFeature(image=_img(8, 8)),
                              np.random.RandomState(0))
    assert out.image.shape == (8, 8, 3)
    assert ti.resize(_img(8, 8), (4, 4)).shape == (4, 4, 3)
    pix = decode_image(encode_image(_img(4, 5)))
    np.testing.assert_array_equal(pix, _img(4, 5))


# ---------------------------------------------------------------------------
# VOC and COCO readers


VOC_XML = """<annotation><filename>{fn}</filename>
<size><width>{w}</width><height>{h}</height><depth>3</depth></size>
{objects}</annotation>"""
VOC_OBJ = """<object><name>{name}</name><difficult>{d}</difficult>
<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>
</bndbox></object>"""


def _write_voc(root, rs, n=6):
    names = list(tds.VOC_CLASSES) + ["unicorn"]
    for i in range(n):
        objs = "".join(VOC_OBJ.format(
            name=names[rs.randint(len(names))], d=int(rs.rand() < 0.3),
            x1=rs.randint(0, 200), y1=rs.randint(0, 150),
            x2=rs.randint(210, 500), y2=rs.randint(160, 375))
            for _ in range(rs.randint(0, 4)))
        (root / f"{i:06d}.xml").write_text(VOC_XML.format(
            fn=f"{i:06d}.jpg", w=500, h=375, objects=objs))
    (root / "notes.txt").write_text("not an annotation")


def _assert_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_read_pascal_voc_matches_jax(tmp_path, keep_difficult):
    _write_voc(tmp_path, np.random.RandomState(2))
    assert tds.VOC_CLASSES == jds.VOC_CLASSES
    _assert_records(
        tds.read_pascal_voc(str(tmp_path), keep_difficult=keep_difficult),
        jds.read_pascal_voc(str(tmp_path), keep_difficult=keep_difficult))


def test_read_coco_matches_jax(tmp_path):
    rs = np.random.RandomState(3)
    blob = {"images": [{"id": i, "file_name": f"{i}.jpg", "width": 640,
                        "height": 480} for i in range(5)],
            "annotations": [{"image_id": int(rs.randint(0, 6)),
                             "bbox": [float(v) for v in rs.uniform(0, 300, 4)],
                             "category_id": int(rs.randint(1, 91))}
                            for _ in range(12)]}
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(blob))
    _assert_records(tds.read_coco(str(path)), jds.read_coco(str(path)))


# ---------------------------------------------------------------------------
# image records through ClusterServing


def _classifier_pair():
    """A narrow MobileNet (3 classes, 32x32) in both packages, the same
    seeded weights."""
    from analytics_zoo_tpu.models.image import mobilenet as jmobilenet
    from analytics_zoo_tpu.nn import reset_name_scope as jreset

    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.models.image import mobilenet
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    jreset()
    jnet = jmobilenet(3, (32, 32, 3), alpha=0.25)
    reset_name_scope()
    tnet = mobilenet(3, (32, 32, 3), alpha=0.25)
    rs = np.random.RandomState(7)
    params = {ln: {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
                   for k, v in leaves.items()}
              for ln, leaves in tnet.params().items()}
    state = {ln: {k: ((0.5 + rs.rand(*v.shape)) if "var" in k
                      else 0.2 * rs.randn(*v.shape)).astype(np.float32)
                  for k, v in leaves.items()}
             for ln, leaves in tnet.state().items() if leaves}
    load_jax_params(tnet, params, state)
    return jnet, tnet, params, state


def _serve_images(mods, model, records, tmp_path):
    cs_mod = importlib.import_module(mods + ".deploy.serving")
    img_mod = importlib.import_module(mods + ".data.image")
    chain = (img_mod.ImageCenterCrop(64, 64) | img_mod.ImageResize(32, 32)
             | img_mod.ImageChannelNormalize(127.0, 127.0, 127.0, 64.0,
                                             64.0, 64.0)
             | img_mod.ImageSetToSample())

    def preprocess(img):
        feat = chain.apply(img_mod.ImageFeature(image=np.array(img)), None)
        return feat["sample"]

    q = cs_mod.MemoryQueue()
    cs = cs_mod.ClusterServing(model, q, cs_mod.ServingConfig(
        postprocess_top_n=2, batch_size=8, max_batch_delay_ms=2.0),
        preprocess=preprocess).start()
    try:
        iq, oq = cs_mod.InputQueue(q), cs_mod.OutputQueue(q)
        for uri, img in records:
            iq.enqueue_image(uri, image=img)
        return {uri: oq.query(uri, timeout=TIMEOUT) for uri, _ in records}
    finally:
        cs.stop()


def _image_records(tmp_path):
    rs = np.random.RandomState(11)
    out = []
    for i in range(12):
        h, w = (64, 64) if i % 2 else (70, 80)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if i % 3 == 0:
            path = tmp_path / f"img{i}.png"
            cv2.imwrite(str(path), img)
            out.append((f"file{i}", str(path)))
        else:
            out.append((f"raw{i}", img))
    return out


def test_cluster_serving_answers_image_records_like_jax(tmp_path):
    """Raw-pixel and png-file image records (``enqueue_image``) through
    ClusterServing with a host preprocess: the port's worker answers as
    the JAX worker does (top-2 indices equal, values within 1e-5)."""
    from analytics_zoo_tpu.deploy.inference import InferenceModel as JaxIM

    from analytics_zoo_tpu_torch.deploy import InferenceModel

    jnet, tnet, params, state = _classifier_pair()
    jm = JaxIM.from_keras_net(
        jnet, jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state))
    tm = InferenceModel.from_keras_net(tnet, params, state, device="cpu",
                                       batch_buckets=(1, 8))
    records = _image_records(tmp_path)
    want = _serve_images("analytics_zoo_tpu", jm, records, tmp_path)
    got = _serve_images("analytics_zoo_tpu_torch", tm, records, tmp_path)
    for uri, w in want.items():
        g = got[uri]
        assert [p[0] for p in g] == [p[0] for p in w], (uri, g, w)
        np.testing.assert_allclose([p[1] for p in g], [p[1] for p in w],
                                   rtol=0, atol=1e-5, err_msg=uri)


def test_compressed_image_record_without_cv2_answers_decode_error(
        tmp_path, monkeypatch):
    """With ``cv2`` hidden, a png-file record is answered with the code
    the JAX worker gives when its ``import cv2`` fails (``decode_error``),
    naming cv2; a raw-pixel record beside it is still served."""
    from analytics_zoo_tpu.deploy import serving as jserving

    from analytics_zoo_tpu_torch.deploy import (ClusterServing,
                                                InferenceModel, InputQueue,
                                                MemoryQueue, OutputQueue,
                                                ServingConfig)

    path = tmp_path / "a.png"
    cv2.imwrite(str(path), _img(8, 8))
    _hide_cv2(monkeypatch)
    codes = {}
    for pkg, (cs_cls, q_cls, iq_cls, oq_cls, cfg_cls, model) in {
            "jax": (jserving.ClusterServing, jserving.MemoryQueue,
                    jserving.InputQueue, jserving.OutputQueue,
                    jserving.ServingConfig,
                    importlib.import_module(
                        "analytics_zoo_tpu.deploy.inference")
                    .InferenceModel(lambda xs: [np.asarray(xs[0]).reshape(
                        len(xs[0]), -1)[:, :2].astype(np.float32)],
                        batch_buckets=(1, 8))),
            "port": (ClusterServing, MemoryQueue, InputQueue, OutputQueue,
                     ServingConfig,
                     InferenceModel(lambda xs: [np.asarray(xs[0]).reshape(
                         len(xs[0]), -1)[:, :2].astype(np.float32)],
                         batch_buckets=(1, 8)))}.items():
        q = q_cls()
        cs = cs_cls(model, q, cfg_cls(batch_size=8,
                                      max_batch_delay_ms=2.0)).start()
        try:
            iq, oq = iq_cls(q), oq_cls(q)
            iq.enqueue_image("file", image=str(path))
            iq.enqueue_image("raw", image=_img(3, 4))
            codes[pkg] = (oq.query("file", timeout=TIMEOUT),
                          oq.query("raw", timeout=TIMEOUT))
        finally:
            cs.stop()
    (jfile, jraw), (tfile, traw) = codes["jax"], codes["port"]
    assert jfile["code"] == tfile["code"] == "decode_error"
    assert "cv2" in tfile["error"]
    np.testing.assert_array_equal(np.asarray(traw), np.asarray(jraw))


def test_redis_reference_client_image_lift(monkeypatch, tmp_path):
    """A reference client's flat {uri, image: b64(png)} stream entry is
    lifted into an image record and served (over the fake redis)."""
    from tests import fake_redis

    monkeypatch.setitem(sys.modules, "redis", fake_redis)
    from analytics_zoo_tpu_torch.deploy import (ClusterServing,
                                                InferenceModel, OutputQueue,
                                                RedisQueue, ServingConfig)
    import base64

    path = tmp_path / "a.png"
    img = _img(6, 7)
    cv2.imwrite(str(path), img)
    q = RedisQueue(name=f"img{time.time_ns()}")
    model = InferenceModel(lambda xs: [np.asarray(xs[0]).reshape(
        len(xs[0]), -1)[:, :4].astype(np.float32)], batch_buckets=(1,))
    cs = ClusterServing(model, q, ServingConfig(batch_size=1)).start()
    try:
        q._r.xadd(q.name, {"uri": "ref0", "image": base64.b64encode(
            path.read_bytes()).decode("ascii")})
        got = OutputQueue(q).query("ref0", timeout=TIMEOUT)
    finally:
        cs.stop()
    np.testing.assert_array_equal(np.asarray(got).ravel(),
                                  img.reshape(-1)[:4].astype(np.float32))
