"""The vision pipeline of the port (``bigdl_tpu/feature/vision``; ref:
dllib/feature/transform/vision/image/: ImageFrame / ImageFeature and the
OpenCV-JNI-backed augmentation ops). Host numpy and PIL; the pipeline
emits NCHW float arrays."""

from bigdl_tpu_torch.feature.vision.image_frame import (
    ImageFeature, ImageFrame, LocalImageFrame)
from bigdl_tpu_torch.feature.vision.transforms import (
    AspectScale, CenterCrop, ChannelNormalize, ChannelScaledNormalizer,
    ColorJitter, FeatureTransformer, Hue, ImageFrameToSample, MatToTensor,
    PixelBytesToMat, RandomCrop, RandomHFlip, RandomTransformer, Resize,
    Brightness, Contrast, Saturation, HFlip)

__all__ = [
    "ImageFeature", "ImageFrame", "LocalImageFrame",
    "FeatureTransformer", "Resize", "AspectScale", "CenterCrop",
    "RandomCrop", "RandomHFlip", "HFlip", "ChannelNormalize",
    "ChannelScaledNormalizer", "MatToTensor", "ImageFrameToSample",
    "PixelBytesToMat", "Brightness", "Contrast", "Saturation", "Hue",
    "ColorJitter", "RandomTransformer",
]
