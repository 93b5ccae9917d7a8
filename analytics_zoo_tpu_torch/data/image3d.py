"""3D (medical) image transforms: crop, rotate, affine.

Reference capability: feature/image3d/{Affine,Cropper,Rotation,Warp,
ImageProcessing3D}.scala (~900 LoC, SURVEY.md §2.1).

Host-side numpy/scipy implementations over (D, H, W) or (D, H, W, C)
volumes, chainable with the 2D pipeline's combinator protocol (the
port's ``data/image.py::ImagePreprocessing``); the JAX package's module,
copied.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.image import ImagePreprocessing


class Crop3D(ImagePreprocessing):
    """Crop a (D,H,W) patch at ``start`` (or centered)
    (reference image3d/Cropper.scala)."""

    def __init__(self, start: Optional[Sequence[int]] = None,
                 patch_size: Sequence[int] = (32, 32, 32)):
        self.start = tuple(start) if start is not None else None
        self.patch = tuple(patch_size)

    def apply(self, feat, rng):
        vol = feat.image
        if self.start is None:
            start = tuple((s - p) // 2 for s, p in zip(vol.shape, self.patch))
        else:
            start = self.start
        sl = tuple(slice(s, s + p) for s, p in zip(start, self.patch))
        feat.image = vol[sl]
        return feat


class RandomCrop3D(ImagePreprocessing):
    def __init__(self, patch_size: Sequence[int]):
        self.patch = tuple(patch_size)

    def apply(self, feat, rng):
        vol = feat.image
        start = tuple(rng.randint(0, max(s - p, 0) + 1)
                      for s, p in zip(vol.shape, self.patch))
        sl = tuple(slice(s, s + p) for s, p in zip(start, self.patch))
        feat.image = vol[sl]
        return feat


class Rotate3D(ImagePreprocessing):
    """Rotate by Euler angles (radians) about the volume center
    (reference image3d/Rotation.scala: rotationAxisAngle)."""

    def __init__(self, yaw: float = 0.0, pitch: float = 0.0,
                 roll: float = 0.0, order: int = 1):
        self.angles = (yaw, pitch, roll)
        self.order = order

    @staticmethod
    def _rot_matrix(yaw, pitch, roll) -> np.ndarray:
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cr, sr = np.cos(roll), np.sin(roll)
        rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        return rz @ ry @ rx

    def apply(self, feat, rng):
        mat = self._rot_matrix(*self.angles)
        return AffineTransform3D(mat, order=self.order).apply(feat, rng)


class AffineTransform3D(ImagePreprocessing):
    """Apply a 3x3 linear map (+ translation) about the center
    (reference image3d/Affine.scala)."""

    def __init__(self, mat: np.ndarray,
                 translation: Sequence[float] = (0, 0, 0), order: int = 1):
        self.mat = np.asarray(mat, np.float64)
        self.translation = np.asarray(translation, np.float64)
        self.order = order

    def apply(self, feat, rng):
        from scipy import ndimage

        vol = feat.image
        center = (np.asarray(vol.shape[:3]) - 1) / 2.0
        # scipy pulls: output(x) = input(matrix @ x + offset)
        inv = np.linalg.inv(self.mat)
        offset = center - inv @ (center + self.translation)

        def warp(v3d):
            return ndimage.affine_transform(
                v3d, inv, offset=offset, order=self.order, mode="nearest")

        if vol.ndim == 4:  # (D, H, W, C): per-channel spatial warp
            feat.image = np.stack(
                [warp(vol[..., c]) for c in range(vol.shape[-1])], axis=-1)
        else:
            feat.image = warp(vol)
        return feat


class Warp3D(ImagePreprocessing):
    """Warp a 3D volume by a dense displacement field with trilinear
    interpolation (reference feature/image3d/Warp.scala /
    WarpTransformer).

    ``field``: (D, H, W, 3) voxel displacements (dz, dy, dx); output voxel
    v = volume[v + field[v]], sampled trilinearly, zero-padded outside.
    """

    def __init__(self, field: np.ndarray, clamp: bool = True):
        self.field = np.asarray(field, np.float32)
        self.clamp = clamp

    def apply(self, feat, rng):
        vol = np.asarray(feat.image, np.float32)
        d, h, w = vol.shape[:3]
        extra = vol.ndim - 3                  # trailing channel dims
        zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                                 indexing="ij")
        src = np.stack([zz, yy, xx], axis=-1).astype(np.float32) + self.field
        if self.clamp:
            src[..., 0] = np.clip(src[..., 0], 0, d - 1)
            src[..., 1] = np.clip(src[..., 1], 0, h - 1)
            src[..., 2] = np.clip(src[..., 2], 0, w - 1)
        # unclipped corner indices: per-corner validity gives true
        # zero-padding (a corner outside the volume contributes 0, the
        # in-range corners keep their trilinear weights)
        z0u = np.floor(src[..., 0]).astype(np.int64)
        y0u = np.floor(src[..., 1]).astype(np.int64)
        x0u = np.floor(src[..., 2]).astype(np.int64)
        wz = src[..., 0] - z0u
        wy = src[..., 1] - y0u
        wx = src[..., 2] - x0u

        def expand(a):
            return a.reshape(a.shape + (1,) * extra)

        wz, wy, wx = expand(wz), expand(wy), expand(wx)

        def corner(zi, yi, xi):
            valid = ((zi >= 0) & (zi < d) & (yi >= 0) & (yi < h)
                     & (xi >= 0) & (xi < w))
            v = vol[np.clip(zi, 0, d - 1), np.clip(yi, 0, h - 1),
                    np.clip(xi, 0, w - 1)]
            return v * expand(valid.astype(np.float32))

        out = ((1 - wz) * (1 - wy) * (1 - wx) * corner(z0u, y0u, x0u)
               + (1 - wz) * (1 - wy) * wx * corner(z0u, y0u, x0u + 1)
               + (1 - wz) * wy * (1 - wx) * corner(z0u, y0u + 1, x0u)
               + (1 - wz) * wy * wx * corner(z0u, y0u + 1, x0u + 1)
               + wz * (1 - wy) * (1 - wx) * corner(z0u + 1, y0u, x0u)
               + wz * (1 - wy) * wx * corner(z0u + 1, y0u, x0u + 1)
               + wz * wy * (1 - wx) * corner(z0u + 1, y0u + 1, x0u)
               + wz * wy * wx * corner(z0u + 1, y0u + 1, x0u + 1))
        feat.image = out.astype(vol.dtype)
        return feat
