"""Vision transformers — the port of
``bigdl_tpu/feature/vision/transforms.py`` (ref:
vision/image/augmentation/*.scala: Resize, AspectScale, CenterCrop,
RandomCrop, HFlip, Brightness / Contrast / Hue / Saturation,
ChannelNormalize, MatToTensor, ImageFrameToSample).

Each FeatureTransformer maps an ImageFeature in place (the reference
mutates the OpenCVMat); images are HWC numpy until MatToTensor emits CHW
floats. PIL is the decode and resize backend (the OpenCV-JNI stand-in),
imported only by the transforms that use it."""

from __future__ import annotations

import io
from typing import Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.feature.vision.image_frame import ImageFeature


class FeatureTransformer:
    """ref: FeatureTransformer — transform(feature); `>>` composes."""

    def __call__(self, feature: ImageFeature) -> ImageFeature:
        try:
            return self.transform_mat(feature)
        except Exception as e:  # ref: ignores per-image failures with log
            feature["isValid"] = False
            feature["error"] = str(e)
            return feature

    def transform_mat(self, feature: ImageFeature) -> ImageFeature:
        raise NotImplementedError

    def __rshift__(self, other):
        return _Chained(self, other)


class _Chained(FeatureTransformer):
    def __init__(self, *ts):
        self.ts = list(ts)

    def __call__(self, feature):
        for t in self.ts:
            feature = t(feature)
        return feature

    def __rshift__(self, other):
        return _Chained(*self.ts, other)


class PixelBytesToMat(FeatureTransformer):
    """Decode encoded bytes → HWC uint8 RGB (ref: PixelBytesToMat /
    BytesToMat via OpenCV imdecode; PIL here)."""

    def transform_mat(self, feature):
        from PIL import Image

        img = Image.open(io.BytesIO(feature[ImageFeature.BYTES]))
        mat = np.asarray(img.convert("RGB"))
        feature[ImageFeature.MAT] = mat
        feature[ImageFeature.ORIGINAL_SIZE] = mat.shape
        return feature


class Resize(FeatureTransformer):
    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def transform_mat(self, feature):
        from PIL import Image

        mat = feature[ImageFeature.MAT]
        img = Image.fromarray(np.asarray(mat, np.uint8))
        feature[ImageFeature.MAT] = np.asarray(
            img.resize((self.w, self.h), Image.BILINEAR))
        return feature


class AspectScale(FeatureTransformer):
    """Scale the short side to ``scale`` keeping aspect (ref: AspectScale,
    the ImageNet eval resize)."""

    def __init__(self, scale: int, max_size: int = 1000):
        self.scale = scale
        self.max_size = max_size

    def transform_mat(self, feature):
        from PIL import Image

        mat = np.asarray(feature[ImageFeature.MAT], np.uint8)
        h, w = mat.shape[:2]
        ratio = self.scale / min(h, w)
        if max(h, w) * ratio > self.max_size:
            ratio = self.max_size / max(h, w)
        img = Image.fromarray(mat)
        feature[ImageFeature.MAT] = np.asarray(img.resize(
            (max(1, round(w * ratio)), max(1, round(h * ratio))),
            Image.BILINEAR))
        return feature


class CenterCrop(FeatureTransformer):
    def __init__(self, crop_h: int, crop_w: int):
        self.ch, self.cw = crop_h, crop_w

    def transform_mat(self, feature):
        mat = feature[ImageFeature.MAT]
        h, w = mat.shape[:2]
        top = max(0, (h - self.ch) // 2)
        left = max(0, (w - self.cw) // 2)
        feature[ImageFeature.MAT] = mat[top:top + self.ch,
                                        left:left + self.cw]
        return feature


class RandomCrop(FeatureTransformer):
    def __init__(self, crop_h: int, crop_w: int, seed: Optional[int] = None):
        self.ch, self.cw = crop_h, crop_w
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        mat = feature[ImageFeature.MAT]
        h, w = mat.shape[:2]
        top = self._rs.randint(0, max(h - self.ch, 0) + 1)
        left = self._rs.randint(0, max(w - self.cw, 0) + 1)
        feature[ImageFeature.MAT] = mat[top:top + self.ch,
                                        left:left + self.cw]
        return feature


class HFlip(FeatureTransformer):
    def transform_mat(self, feature):
        feature[ImageFeature.MAT] = feature[ImageFeature.MAT][:, ::-1]
        return feature


class RandomHFlip(FeatureTransformer):
    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        if self._rs.rand() < self.p:
            feature[ImageFeature.MAT] = feature[ImageFeature.MAT][:, ::-1]
        return feature


class Brightness(FeatureTransformer):
    def __init__(self, delta_low: float, delta_high: float,
                 seed: Optional[int] = None):
        self.lo, self.hi = delta_low, delta_high
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        delta = self._rs.uniform(self.lo, self.hi)
        mat = np.asarray(feature[ImageFeature.MAT], np.float32) + delta
        feature[ImageFeature.MAT] = np.clip(mat, 0, 255)
        return feature


class Contrast(FeatureTransformer):
    def __init__(self, delta_low: float, delta_high: float,
                 seed: Optional[int] = None):
        self.lo, self.hi = delta_low, delta_high
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        scale = self._rs.uniform(self.lo, self.hi)
        mat = np.asarray(feature[ImageFeature.MAT], np.float32) * scale
        feature[ImageFeature.MAT] = np.clip(mat, 0, 255)
        return feature


class Saturation(FeatureTransformer):
    def __init__(self, delta_low: float, delta_high: float,
                 seed: Optional[int] = None):
        self.lo, self.hi = delta_low, delta_high
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        s = self._rs.uniform(self.lo, self.hi)
        mat = np.asarray(feature[ImageFeature.MAT], np.float32)
        grey = mat.mean(axis=2, keepdims=True)
        feature[ImageFeature.MAT] = np.clip(grey + (mat - grey) * s, 0, 255)
        return feature


class Hue(FeatureTransformer):
    def __init__(self, delta_low: float = -18, delta_high: float = 18,
                 seed: Optional[int] = None):
        self.lo, self.hi = delta_low, delta_high
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        import colorsys  # noqa: F401  (documents the op)
        from PIL import Image

        delta = self._rs.uniform(self.lo, self.hi)
        img = Image.fromarray(np.asarray(feature[ImageFeature.MAT],
                                         np.uint8)).convert("HSV")
        hsv = np.asarray(img, np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(delta * 255 / 360)) % 256
        feature[ImageFeature.MAT] = np.asarray(Image.fromarray(
            hsv.astype(np.uint8), "HSV").convert("RGB"))
        return feature


class ColorJitter(FeatureTransformer):
    """ref: ColorJitter — random brightness/contrast/saturation order."""

    def __init__(self, brightness: float = 32, contrast: float = 0.5,
                 saturation: float = 0.5, seed: Optional[int] = None):
        self._ts = [Brightness(-brightness, brightness, seed),
                    Contrast(1 - contrast, 1 + contrast, seed),
                    Saturation(1 - saturation, 1 + saturation, seed)]
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        order = self._rs.permutation(len(self._ts))
        for i in order:
            feature = self._ts[i](feature)
        return feature


class RandomTransformer(FeatureTransformer):
    """Apply inner transformer with probability p (ref: RandomTransformer)."""

    def __init__(self, transformer: FeatureTransformer, p: float = 0.5,
                 seed: Optional[int] = None):
        self.inner = transformer
        self.p = p
        self._rs = np.random.RandomState(seed)

    def transform_mat(self, feature):
        if self._rs.rand() < self.p:
            return self.inner(feature)
        return feature


class ChannelNormalize(FeatureTransformer):
    """(x - mean) / std per channel (ref: ChannelNormalize)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 std_r: float = 1.0, std_g: float = 1.0,
                 std_b: float = 1.0):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def transform_mat(self, feature):
        mat = np.asarray(feature[ImageFeature.MAT], np.float32)
        feature[ImageFeature.MAT] = (mat - self.mean) / self.std
        return feature


class ChannelScaledNormalizer(FeatureTransformer):
    def __init__(self, scale: float = 1.0 / 255):
        self.scale = scale

    def transform_mat(self, feature):
        feature[ImageFeature.MAT] = np.asarray(
            feature[ImageFeature.MAT], np.float32) * self.scale
        return feature


class MatToTensor(FeatureTransformer):
    """HWC → CHW float (ref: MatToTensor — emits the NCHW tensor the
    models consume)."""

    def __init__(self, to_rgb: bool = False):
        self.to_rgb = to_rgb

    def transform_mat(self, feature):
        mat = np.asarray(feature[ImageFeature.MAT], np.float32)
        if mat.ndim == 2:
            mat = mat[..., None]
        if self.to_rgb:
            mat = mat[..., ::-1]
        feature[ImageFeature.FLOATS] = np.ascontiguousarray(
            mat.transpose(2, 0, 1))
        return feature


class ImageFrameToSample(FeatureTransformer):
    """Pack floats (+label) into a Sample (ref: ImageFrameToSample)."""

    def __init__(self, input_keys: Sequence[str] = (ImageFeature.FLOATS,),
                 target_keys: Optional[Sequence[str]] = None):
        self.input_keys = list(input_keys)
        self.target_keys = list(target_keys) if target_keys else None

    def transform_mat(self, feature):
        from bigdl_tpu_torch.feature.dataset import Sample

        xs = [np.asarray(feature[k], np.float32) for k in self.input_keys]
        x = xs[0] if len(xs) == 1 else xs
        t = None
        if self.target_keys:
            ts = [np.asarray(feature[k]) for k in self.target_keys]
            t = ts[0] if len(ts) == 1 else ts
        elif ImageFeature.LABEL in feature:
            t = np.asarray(feature[ImageFeature.LABEL])
        feature[ImageFeature.SAMPLE] = Sample(x, t)
        return feature
