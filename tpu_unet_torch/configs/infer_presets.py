"""Inference wrapper presets — the reference's <Variant>_config.py files as
keyword presets for :class:`tpu_unet_torch.infer.wrapper.Unet` (the port's
own copy of ``tpu_unet/configs/infer_presets.py``)."""
from __future__ import annotations

INFER_PRESETS = {
    # reference: unet.py:23-55 (canonical wrapper defaults)
    "unet": dict(model=None, backbone="vgg", num_classes=4,
                 input_shape=[256, 256], mix_type=0),
    # reference: TraditionalUnet_config.py:23-100
    "traditional": dict(model="traditional", num_classes=4,
                        input_shape=[256, 256], mix_type=0),
    # reference: LightweightUnet_config.py
    "lightweight": dict(model="lightweight", num_classes=4,
                        input_shape=[256, 256], mix_type=0),
    # reference: UltraLightweightUnet_config.py
    "ultralight": dict(model="ultralight", num_classes=4,
                       input_shape=[256, 256], mix_type=0),
    # reference: UltraLightweightUnet_large_config.py
    "ultralight_large": dict(model="ultralight_large", num_classes=4,
                             input_shape=[256, 256], mix_type=0),
    # reference: UltraLightweightUnet_large_optimized_config.py
    "ultralight_large_optimized": dict(model="ultralight_large_optimized",
                                       num_classes=4, input_shape=[256, 256],
                                       mix_type=0),
    # VOC 21-class canonical setups (README.md:74-105)
    "voc_vgg": dict(model="unet_vgg", num_classes=21, input_shape=[512, 512],
                    mix_type=0),
    "voc_resnet50": dict(model="unet_resnet50", num_classes=21,
                         input_shape=[512, 512], mix_type=0),
    # medical 2-class (train_medical.py:79,115)
    "medical": dict(model="unet_vgg", num_classes=2, input_shape=[512, 512],
                    mix_type=0),
}


def build_wrapper(preset: str, **overrides):
    """``Unet`` of ``preset`` with ``overrides`` (``cuda=False`` for the
    CPU, ``model_path``, ``num_classes``, ...) on top."""
    from tpu_unet_torch.infer.wrapper import Unet

    if preset not in INFER_PRESETS:
        raise KeyError(f"unknown inference preset {preset!r}; available: "
                       f"{sorted(INFER_PRESETS)}")
    return Unet(**{**INFER_PRESETS[preset], **overrides})
