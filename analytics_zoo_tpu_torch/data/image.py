"""Image pipeline: ``ImageSet`` and its host preprocessors, the JAX
package's ``data/image.py``.

Preprocessing is host work in both packages: numpy over HWC arrays in
OpenCV's BGR order, producing dense NHWC float32 batches for the device.
The transforms make the JAX module's ``np.random.RandomState`` calls in
its order, so a seeded chain crops, flips and expands bit for bit as
the JAX one does (``ImageSet.to_arrays`` seeds each image from (seed,
epoch_seed, index), as there).

OpenCV is not a dependency of the port.  Resizing and the HSV round
trip of ``ImageHue`` are the port's own code, one path whether ``cv2``
is installed or not:

- ``resize`` follows ``cv2.resize``: bilinear (``INTER_LINEAR``) with
  half-pixel centres, clamped edges and no antialiasing, uint8 images
  through 11-bit fixed-point weights as OpenCV's vectorised path
  rounds them (within one level of ``cv2.resize`` everywhere); nearest (``INTER_NEAREST``) takes ``floor(dst * src / dst)``;
- ``bgr_to_hsv`` / ``hsv_to_bgr`` follow OpenCV's uint8 convention (H
  in [0, 180), S and V scaled to 255; its integer tables one way and
  its float sectors the other).

Reading files and decoding compressed bytes (jpg/png) stay on ``cv2``, as
in the JAX package, imported where they run; without it they raise
:class:`Cv2Unavailable`, an ``ImportError`` naming ``cv2``.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_COEF_BITS = 11                  # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_HSV_SHIFT = 12


class Cv2Unavailable(ImportError):
    """An operation that needs OpenCV (``cv2``: reading image files,
    decoding jpg/png bytes, drawing) ran where it is not installed."""


def require_cv2(what: str):
    """The ``cv2`` module, or :class:`Cv2Unavailable` naming ``what``."""
    try:
        import cv2
    except ImportError as e:
        raise Cv2Unavailable(
            f"{what} needs OpenCV (the cv2 module), which is not installed "
            f"here; raw pixel arrays need no cv2") from e
    return cv2


# ---------------------------------------------------------------------------
# resize and HSV, as OpenCV computes them
# ---------------------------------------------------------------------------

def _linear_taps(src: int, dst: int):
    """Per output position: the two source taps and the weight of the
    second, as ``cv2.resize``'s INTER_LINEAR sets them up."""
    scale = src / dst
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s0 = np.floor(f).astype(np.int64)
    f = (f - s0).astype(np.float32)
    low = s0 < 0
    f[low], s0[low] = 0.0, 0
    high = s0 >= src - 1
    f[high], s0[high] = 0.0, src - 1
    return s0, np.minimum(s0 + 1, src - 1), f


def _nearest_taps(src: int, dst: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (src / dst)).astype(
        np.int64), src - 1)


def resize(img: np.ndarray, size: Tuple[int, int],
           interpolation: str = "bilinear") -> np.ndarray:
    """``img`` (H, W) or (H, W, C) resized to ``size`` = (width, height),
    ``cv2.resize``'s argument order; ``interpolation`` is "bilinear" or
    "nearest".  The result keeps ``img``'s dtype."""
    img = np.asarray(img)
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if interpolation == "nearest":
        return np.ascontiguousarray(
            img[_nearest_taps(sh, h)][:, _nearest_taps(sw, w)])
    if interpolation != "bilinear":
        raise ValueError(f"interpolation must be bilinear|nearest, got "
                         f"{interpolation!r}")
    y0, y1, fy = _linear_taps(sh, h)
    x0, x1, fx = _linear_taps(sw, w)
    extra = (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        # OpenCV's fixed point: each weight rounded to 11 bits, a row
        # pass in int, then its vectorised column pass (rows shifted
        # right by 4, 16-bit high products, a final rounding shift by 2)
        one = np.float32(1.0)
        scale = np.float32(_COEF_SCALE)
        # int32 holds every partial sum: 255 * 2049 in the row pass,
        # 2^15 * 2^11 in the column pass
        ax = [np.rint((one - fx) * scale).astype(np.int32),
              np.rint(fx * scale).astype(np.int32)]
        ay = [np.rint((one - fy) * scale).astype(np.int32),
              np.rint(fy * scale).astype(np.int32)]
        src = img.astype(np.int32)
        rows = (src[:, x0] * ax[0][(None, slice(None)) + extra]
                + src[:, x1] * ax[1][(None, slice(None)) + extra])
        out = ((((rows[y0] >> 4) * ay[0][(slice(None), None) + extra])
                >> 16) + (((rows[y1] >> 4)
                           * ay[1][(slice(None), None) + extra]) >> 16)
               + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    ftype = img.dtype.type if img.dtype in (np.float32, np.float64) \
        else np.float32
    src = img.astype(ftype, copy=False)
    fx, fy = fx.astype(ftype), fy.astype(ftype)
    one = ftype(1.0)
    rows = (src[:, x0] * (one - fx)[(None, slice(None)) + extra]
            + src[:, x1] * fx[(None, slice(None)) + extra])
    out = (rows[y0] * (one - fy)[(slice(None), None) + extra]
           + rows[y1] * fy[(slice(None), None) + extra])
    if img.dtype in (np.float32, np.float64):
        return out
    info = np.iinfo(img.dtype)
    return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)


def _cv_round(x: np.ndarray) -> np.ndarray:
    return np.rint(x).astype(np.int64)


_SDIV = np.concatenate([[0], _cv_round(
    (255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))])
_HDIV180 = np.concatenate([[0], _cv_round(
    (180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))])


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 BGR (H, W, 3) -> uint8 HSV, OpenCV's ``COLOR_BGR2HSV``: H
    in [0, 180), S and V in [0, 255], through its integer tables."""
    px = np.asarray(img, np.uint8).astype(np.int64)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.clip(np.stack([h, s, v], -1), 0, 255).astype(np.uint8)


# OpenCV's HSV2RGB sector table: which of (v, p, q, t) each of B, G, R
# takes in sectors 0..5
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (OpenCV's convention) -> uint8 BGR, OpenCV's
    ``COLOR_HSV2BGR``: in float32, H scaled by 6/180 into six sectors,
    each channel rounded half to even."""
    px = np.asarray(hsv, np.uint8)
    f32 = np.float32
    h = px[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = px[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = px[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6.0))
    h = np.where(h < 0, h + f32(6.0), h).astype(f32)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector).astype(f32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, f32(0.0), h)
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], -1).astype(f32)
    pick = _SECTORS[sector]                              # (..., 3)
    bgr = np.take_along_axis(tab, pick, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.rint(bgr * f32(255.0)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# features and transforms
# ---------------------------------------------------------------------------

class ImageFeature(dict):
    """Mutable record for one image flowing through the pipeline (keys
    image / label / path / bboxes ...)."""

    @property
    def image(self) -> np.ndarray:
        return self["image"]

    @image.setter
    def image(self, v) -> None:
        self["image"] = v

    @property
    def label(self):
        return self.get("label")


class ImagePreprocessing:
    """A chainable per-image transform (``|`` / ``chain``)."""

    def apply(self, feat: ImageFeature, rng: np.random.RandomState
              ) -> ImageFeature:
        raise NotImplementedError

    def __or__(self, other: "ImagePreprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])

    def chain(self, other: "ImagePreprocessing") -> "ChainedPreprocessing":
        return self | other

    def __call__(self, feat, rng=None):
        rng = rng or np.random.RandomState()
        return self.apply(feat, rng)


class ChainedPreprocessing(ImagePreprocessing):
    def __init__(self, stages: Sequence[ImagePreprocessing]):
        self.stages = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                self.stages.extend(s.stages)
            else:
                self.stages.append(s)

    def apply(self, feat, rng):
        for s in self.stages:
            feat = s.apply(feat, rng)
        return feat


class ImageResize(ImagePreprocessing):
    """Resize to (resize_h, resize_w); ``mode`` "bilinear" or
    "nearest"."""

    def __init__(self, resize_h: int, resize_w: int, mode: str = "bilinear"):
        self.h, self.w = resize_h, resize_w
        self.interp = "nearest" if mode == "nearest" else "bilinear"

    def apply(self, feat, rng):
        feat.image = resize(feat.image, (self.w, self.h), self.interp)
        return feat


class ImageAspectScale(ImagePreprocessing):
    """Scale the short edge to ``min_size`` keeping the aspect ratio, the
    long edge capped at ``max_size``."""

    def __init__(self, min_size: int, max_size: int = 1000,
                 scale_multiple_of: int = 1):
        self.min_size, self.max_size = min_size, max_size
        self.multiple = scale_multiple_of

    def apply(self, feat, rng):
        img = feat.image
        h, w = img.shape[:2]
        short, long_ = min(h, w), max(h, w)
        scale = self.min_size / short
        if scale * long_ > self.max_size:
            scale = self.max_size / long_
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if self.multiple > 1:
            nh = (nh // self.multiple) * self.multiple
            nw = (nw // self.multiple) * self.multiple
        feat.image = resize(img, (nw, nh))
        feat["scale"] = scale
        return feat


class ImageRandomAspectScale(ImagePreprocessing):
    """A random short-edge size from ``scales``."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000):
        self.scales = list(scales)
        self.max_size = max_size

    def apply(self, feat, rng):
        size = self.scales[rng.randint(len(self.scales))]
        return ImageAspectScale(size, self.max_size).apply(feat, rng)


class ImageCenterCrop(ImagePreprocessing):
    def __init__(self, crop_height: int, crop_width: int):
        self.ch, self.cw = crop_height, crop_width

    def apply(self, feat, rng):
        img = feat.image
        h, w = img.shape[:2]
        top = max((h - self.ch) // 2, 0)
        left = max((w - self.cw) // 2, 0)
        feat.image = img[top:top + self.ch, left:left + self.cw]
        return feat


class ImageRandomCrop(ImagePreprocessing):
    def __init__(self, crop_height: int, crop_width: int):
        self.ch, self.cw = crop_height, crop_width

    def apply(self, feat, rng):
        img = feat.image
        h, w = img.shape[:2]
        top = rng.randint(0, max(h - self.ch, 0) + 1)
        left = rng.randint(0, max(w - self.cw, 0) + 1)
        feat.image = img[top:top + self.ch, left:left + self.cw]
        return feat


class ImageHFlip(ImagePreprocessing):
    def apply(self, feat, rng):
        feat.image = feat.image[:, ::-1]
        return feat


class ImageRandomHFlip(ImagePreprocessing):
    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, feat, rng):
        if rng.rand() < self.p:
            feat.image = feat.image[:, ::-1]
        return feat


class ImageChannelOrder(ImagePreprocessing):
    """BGR <-> RGB swap."""

    def apply(self, feat, rng):
        feat.image = feat.image[..., ::-1]
        return feat


class ImageBrightness(ImagePreprocessing):
    """Add a uniform delta in [delta_low, delta_high]."""

    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = delta_low, delta_high

    def apply(self, feat, rng):
        delta = rng.uniform(self.lo, self.hi)
        feat.image = feat.image.astype(np.float32) + delta
        return feat


class ImageContrast(ImagePreprocessing):
    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = delta_low, delta_high

    def apply(self, feat, rng):
        factor = rng.uniform(self.lo, self.hi)
        feat.image = feat.image.astype(np.float32) * factor
        return feat


class ImageSaturation(ImagePreprocessing):
    def __init__(self, delta_low: float, delta_high: float):
        self.lo, self.hi = delta_low, delta_high

    def apply(self, feat, rng):
        factor = rng.uniform(self.lo, self.hi)
        img = feat.image.astype(np.float32)
        gray = img.mean(axis=-1, keepdims=True)
        feat.image = gray + (img - gray) * factor
        return feat


class ImageHue(ImagePreprocessing):
    """Shift the hue by a uniform delta (whole degrees of OpenCV's
    0..180 hue) through the port's uint8 HSV round trip."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0):
        self.lo, self.hi = delta_low, delta_high

    def apply(self, feat, rng):
        delta = rng.uniform(self.lo, self.hi)
        img = np.clip(feat.image, 0, 255).astype(np.uint8)
        hsv = bgr_to_hsv(img).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(delta)) % 180
        feat.image = hsv_to_bgr(hsv.astype(np.uint8)).astype(np.float32)
        return feat


class ImageColorJitter(ImagePreprocessing):
    """Random brightness / contrast / saturation in a random order."""

    def __init__(self, brightness=(-32, 32), contrast=(0.5, 1.5),
                 saturation=(0.5, 1.5)):
        self.stages = [ImageBrightness(*brightness),
                       ImageContrast(*contrast),
                       ImageSaturation(*saturation)]

    def apply(self, feat, rng):
        for i in rng.permutation(len(self.stages)):
            feat = self.stages[i].apply(feat, rng)
        return feat


class ImageExpand(ImagePreprocessing):
    """Place the image at random on a larger mean-filled canvas (SSD's
    zoom-out augmentation)."""

    def __init__(self, means=(123.0, 117.0, 104.0),
                 max_expand_ratio: float = 4.0):
        self.means = np.asarray(means, np.float32)
        self.max_ratio = max_expand_ratio

    def apply(self, feat, rng):
        img = feat.image.astype(np.float32)
        h, w = img.shape[:2]
        ratio = rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        top = rng.randint(0, nh - h + 1)
        left = rng.randint(0, nw - w + 1)
        canvas = np.ones((nh, nw, img.shape[2]), np.float32) * self.means
        canvas[top:top + h, left:left + w] = img
        feat.image = canvas
        feat["expand"] = (top, left, ratio)
        return feat


class ImageChannelNormalize(ImagePreprocessing):
    """Per-channel (x - mean) / std; means and stds given R, G, B and
    applied B, G, R (pipeline images are OpenCV BGR)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 std_r: float = 1.0, std_g: float = 1.0, std_b: float = 1.0):
        self.mean = np.asarray([mean_b, mean_g, mean_r], np.float32)
        self.std = np.asarray([std_b, std_g, std_r], np.float32)

    def apply(self, feat, rng):
        feat.image = (feat.image.astype(np.float32) - self.mean) / self.std
        return feat


class ImagePixelNormalizer(ImagePreprocessing):
    """Subtract a full per-pixel mean image."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply(self, feat, rng):
        feat.image = feat.image.astype(np.float32) - self.means
        return feat


class ImageSetToSample(ImagePreprocessing):
    """Finalise: a contiguous float32 HWC array under ``sample``."""

    def apply(self, feat, rng):
        img = np.asarray(feat.image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        feat["sample"] = np.ascontiguousarray(img)
        return feat


ImageMatToTensor = ImageSetToSample


class ImageSet:
    """A list of ImageFeatures and a lazy transform chain."""

    def __init__(self, features: List[ImageFeature],
                 transforms: Optional[ImagePreprocessing] = None,
                 seed: int = 0):
        self.features = features
        self.transforms = transforms
        self.seed = seed

    # -- constructors ------------------------------------------------------
    @staticmethod
    def read(path: str, with_label: bool = False,
             one_based_label: bool = True, max_images: Optional[int] = None,
             num_shards: int = 1, shard_index: int = 0) -> "ImageSet":
        """Read image files from a directory (or glob) with ``cv2``.  With
        ``with_label``, the immediate subdirectory names become class
        labels (sorted), numbered over the whole listing before sharding
        (``num_shards`` / ``shard_index``) and ``max_images``."""
        if os.path.isdir(path):
            pats = [os.path.join(path, "**", "*.*")]
        else:
            pats = [path]
        files = sorted(f for p in pats for f in _glob.glob(p, recursive=True)
                       if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        label_map: Dict[str, int] = {}
        if with_label:
            classes = sorted({os.path.basename(os.path.dirname(f))
                              for f in files})
            base = 1 if one_based_label else 0
            label_map = {c: i + base for i, c in enumerate(classes)}
        files = files[shard_index::num_shards]
        if max_images:
            files = files[:max_images]
        feats = []
        if files:
            cv2 = require_cv2("ImageSet.read (decoding image files)")
        for f in files:
            img = cv2.imread(f, cv2.IMREAD_COLOR)
            if img is None:
                continue
            feat = ImageFeature(image=img, path=f)
            if with_label:
                feat["label"] = label_map[os.path.basename(os.path.dirname(f))]
            feats.append(feat)
        im = ImageSet(feats)
        im.label_map = label_map
        return im

    @staticmethod
    def from_arrays(images: Sequence[np.ndarray],
                    labels: Optional[Sequence] = None) -> "ImageSet":
        feats = []
        for i, img in enumerate(images):
            f = ImageFeature(image=np.asarray(img))
            if labels is not None:
                f["label"] = labels[i]
            feats.append(f)
        return ImageSet(feats)

    # -- transform ---------------------------------------------------------
    def transform(self, preprocessing: ImagePreprocessing) -> "ImageSet":
        t = (preprocessing if self.transforms is None
             else self.transforms | preprocessing)
        return ImageSet(self.features, t, self.seed)

    def get_image(self, idx: int = 0) -> np.ndarray:
        """Apply the chain to one image (a peek)."""
        rng = np.random.RandomState(self.seed + idx)
        feat = ImageFeature(self.features[idx])
        if self.transforms is not None:
            feat = self.transforms.apply(feat, rng)
        return feat.get("sample", feat.image)

    def __len__(self):
        return len(self.features)

    # -- materialization ---------------------------------------------------
    def transformed(self, epoch_seed: int = 0,
                    num_workers: Optional[int] = None
                    ) -> List[ImageFeature]:
        """Every feature after the chain.  Each image's RandomState
        depends only on (seed, epoch_seed, index), so the worker count
        (a thread pool; numpy releases the GIL) never changes the
        output."""
        def one(idx):
            rng = np.random.RandomState(
                (self.seed + epoch_seed * 1_000_003 + idx) % (2 ** 31))
            feat = ImageFeature(self.features[idx])
            if self.transforms is not None:
                feat = self.transforms.apply(feat, rng)
            return feat

        n = len(self.features)
        if num_workers is None:
            num_workers = min(8, os.cpu_count() or 1)
        if num_workers > 1 and n >= 4 * num_workers:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_workers) as ex:
                return list(ex.map(one, range(n)))
        return [one(i) for i in range(n)]

    def to_arrays(self, epoch_seed: int = 0, num_workers: Optional[int] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The chain applied to every image: (images stacked as float32,
        labels or None)."""
        feats = self.transformed(epoch_seed, num_workers)
        imgs = [np.asarray(f.get("sample", f.image), np.float32)
                for f in feats]
        labels = [f.label for f in feats if f.label is not None]
        x = np.stack(imgs)
        if labels and len(labels) != len(imgs):
            raise ValueError(
                f"{len(imgs) - len(labels)} of {len(imgs)} images have no "
                "label — refusing to silently misalign images and labels")
        y = np.asarray(labels) if labels else None
        return x, y

    def to_feature_set(self, memory_type: str = "DRAM"):
        from analytics_zoo_tpu_torch.data.featureset import FeatureSet

        x, y = self.to_arrays()
        return FeatureSet.from_ndarrays(x, y, memory_type=memory_type)


class ImageBytesToMat(ImagePreprocessing):
    """Decode encoded image bytes (jpeg/png) into a BGR image, with
    ``cv2``."""

    def __init__(self, byte_key: str = "bytes"):
        self.byte_key = byte_key

    def apply(self, feat, rng):
        cv2 = require_cv2("ImageBytesToMat (decoding jpg/png bytes)")
        buf = np.frombuffer(feat[self.byte_key], np.uint8)
        feat.image = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if feat.image is None:
            raise ValueError("undecodable image bytes")
        return feat


class ImagePixelBytesToMat(ImagePreprocessing):
    """Raw pixel bytes (H * W * C uint8) -> image, its shape from the
    feature's height / width / nChannels."""

    def __init__(self, byte_key: str = "bytes"):
        self.byte_key = byte_key

    def apply(self, feat, rng):
        h, w = int(feat["height"]), int(feat["width"])
        c = int(feat.get("nChannels", 3))
        arr = np.frombuffer(feat[self.byte_key], np.uint8)
        feat.image = arr.reshape(h, w, c).copy()
        return feat


class ImageMatToFloats(ImagePreprocessing):
    """Image -> float32 HWC array under ``floats``."""

    def apply(self, feat, rng):
        img = np.asarray(feat.image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        feat["floats"] = img
        return feat


class ImageFeatureToTensor(ImagePreprocessing):
    """Finalise (``ImageSetToSample``'s contract)."""

    def apply(self, feat, rng):
        return ImageSetToSample().apply(feat, rng)


class ImageFiller(ImagePreprocessing):
    """Fill a normalised-coordinate region with a constant (occlusion)."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: float = 255.0):
        self.box = (start_x, start_y, end_x, end_y)
        self.value = value

    def apply(self, feat, rng):
        img = feat.image
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        img = img.copy()
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        feat.image = img
        return feat


class ImageFixedCrop(ImagePreprocessing):
    """Crop a fixed box, normalised (0..1) or in pixels."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def apply(self, feat, rng):
        img = feat.image
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        feat.image = img[int(y1):int(y2), int(x1):int(x2)].copy()
        feat["crop"] = (int(x1), int(y1), int(x2), int(y2))
        return feat


class ImageMirror(ImageHFlip):
    """Horizontal mirror (the same op as ``ImageHFlip``)."""


class ImageChannelScaledNormalizer(ImagePreprocessing):
    """(x - channel mean) * scale, means given R, G, B."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 scale: float = 1.0):
        self.mean = np.asarray([mean_b, mean_g, mean_r], np.float32)
        self.scale = scale

    def apply(self, feat, rng):
        feat.image = (feat.image.astype(np.float32) - self.mean) * self.scale
        return feat


class ImageRandomPreprocessing(ImagePreprocessing):
    """Apply ``preprocessing`` with probability ``prob``."""

    def __init__(self, preprocessing: ImagePreprocessing, prob: float = 0.5):
        self.inner = preprocessing
        self.prob = prob

    def apply(self, feat, rng):
        if rng.rand() < self.prob:
            return self.inner.apply(feat, rng)
        return feat


class ImageRandomResize(ImagePreprocessing):
    """Resize to a random square size in [min_size, max_size]."""

    def __init__(self, min_size: int, max_size: int):
        self.min_size, self.max_size = min_size, max_size

    def apply(self, feat, rng):
        s = int(rng.randint(self.min_size, self.max_size + 1))
        feat.image = resize(feat.image, (s, s))
        return feat


class ImageRandomCropper(ImagePreprocessing):
    """Random crop to (crop_width, crop_height), enlarging a smaller
    image first, with an optional random mirror."""

    def __init__(self, crop_width: int, crop_height: int,
                 mirror: bool = True):
        self.cw, self.ch = crop_width, crop_height
        self.mirror = mirror

    def apply(self, feat, rng):
        img = feat.image
        h, w = img.shape[:2]
        if h < self.ch or w < self.cw:
            img = resize(img, (max(w, self.cw), max(h, self.ch)))
            h, w = img.shape[:2]
        top = rng.randint(0, h - self.ch + 1)
        left = rng.randint(0, w - self.cw + 1)
        img = img[top:top + self.ch, left:left + self.cw]
        if self.mirror and rng.rand() < 0.5:
            img = img[:, ::-1]
        feat.image = np.ascontiguousarray(img)
        return feat


# ---------------------------------------------------------------------------
# ROI-aware transforms: the image and its ground-truth boxes together.
# Boxes are feat["bboxes"], (N, 4) [x1, y1, x2, y2], pixels unless
# feat["bboxes_normalized"].
# ---------------------------------------------------------------------------

class RoiNormalize(ImagePreprocessing):
    """Pixel boxes -> [0, 1] coordinates."""

    def apply(self, feat, rng):
        if "bboxes" in feat:
            h, w = feat.image.shape[:2]
            b = np.asarray(feat["bboxes"], np.float32).copy()
            b[:, [0, 2]] /= w
            b[:, [1, 3]] /= h
            feat["bboxes"] = b
            feat["bboxes_normalized"] = True
        return feat


class RoiHFlip(ImagePreprocessing):
    """Flip the image and its boxes horizontally."""

    def __init__(self, normalized: bool = True):
        self.normalized = normalized

    def apply(self, feat, rng):
        feat.image = feat.image[:, ::-1].copy()
        if "bboxes" in feat:
            b = np.asarray(feat["bboxes"], np.float32).copy()
            width = 1.0 if self.normalized else feat.image.shape[1]
            b[:, [0, 2]] = width - b[:, [2, 0]]
            feat["bboxes"] = b
        return feat


class RoiResize(ImagePreprocessing):
    """Resize the image (bilinear); pixel boxes scale with it."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def apply(self, feat, rng):
        h0, w0 = feat.image.shape[:2]
        feat.image = resize(feat.image, (self.w, self.h))
        if "bboxes" in feat and not feat.get("bboxes_normalized"):
            b = np.asarray(feat["bboxes"], np.float32).copy()
            b[:, [0, 2]] *= self.w / w0
            b[:, [1, 3]] *= self.h / h0
            feat["bboxes"] = b
        return feat


class RandomSampler(ImagePreprocessing):
    """SSD's random IoU-constrained crop: draw a minimum IoU (or none),
    then up to ``max_trials`` crops (scale in [min_scale, 1], aspect in
    [1/2, 2]) until one overlaps some box by that much and holds a box
    centre; keep the boxes whose centres fall inside, clipped and
    shifted."""

    def __init__(self, min_scale: float = 0.3,
                 min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), max_trials: int = 25):
        self.min_scale = min_scale
        self.min_ious = list(min_ious) + [None]   # None: no constraint
        self.max_trials = max_trials

    @staticmethod
    def _iou(boxes, crop):
        x1 = np.maximum(boxes[:, 0], crop[0])
        y1 = np.maximum(boxes[:, 1], crop[1])
        x2 = np.minimum(boxes[:, 2], crop[2])
        y2 = np.minimum(boxes[:, 3], crop[3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        area_c = (crop[2] - crop[0]) * (crop[3] - crop[1])
        return inter / np.maximum(area_b + area_c - inter, 1e-9)

    def apply(self, feat, rng):
        if "bboxes" not in feat or len(feat["bboxes"]) == 0:
            return feat
        img = feat.image
        h, w = img.shape[:2]
        boxes = np.asarray(feat["bboxes"], np.float32)
        labels = np.asarray(feat.get("label", np.zeros(len(boxes))))
        min_iou = self.min_ious[rng.randint(len(self.min_ious))]
        if min_iou is None:
            return feat
        for _ in range(self.max_trials):
            cw = rng.uniform(self.min_scale, 1.0) * w
            chh = rng.uniform(self.min_scale, 1.0) * h
            if not 0.5 <= cw / chh <= 2.0:
                continue
            left = rng.uniform(0, w - cw)
            top = rng.uniform(0, h - chh)
            # an integer crop box: the cropped image and the shifted
            # boxes share one coordinate frame
            crop = np.array([int(left), int(top), int(left + cw),
                             int(top + chh)], np.float32)
            if self._iou(boxes, crop).max() < min_iou:
                continue
            cx = (boxes[:, 0] + boxes[:, 2]) / 2
            cy = (boxes[:, 1] + boxes[:, 3]) / 2
            keep = ((cx >= crop[0]) & (cx <= crop[2])
                    & (cy >= crop[1]) & (cy <= crop[3]))
            if not keep.any():
                continue
            kept = boxes[keep].copy()
            kept[:, [0, 2]] = np.clip(kept[:, [0, 2]], crop[0], crop[2]) \
                - crop[0]
            kept[:, [1, 3]] = np.clip(kept[:, [1, 3]], crop[1], crop[3]) \
                - crop[1]
            feat.image = img[int(crop[1]):int(crop[3]),
                             int(crop[0]):int(crop[2])].copy()
            feat["bboxes"] = kept
            feat["label"] = labels[keep]
            return feat
        return feat


class RowToImageFeature(ImagePreprocessing):
    """An image-schema row (origin / height / width / nChannels / mode /
    data) -> ImageFeature."""

    def apply(self, feat, rng):
        return feat          # already an ImageFeature

    @staticmethod
    def from_row(row) -> ImageFeature:
        return ImageFeature(image=np.asarray(row["data"]),
                            path=row.get("origin", ""))


class BufferedImageResize(ImageResize):
    """The reference's BufferedImageResize: one resize serves both of
    its paths."""
