"""The ``Unet`` inference wrapper of the port (counterpart of
``tpu_unet/infer/wrapper.py``): the batched serving step.

Same I/O contract as the JAX wrapper's ``serving_step``: a uint8
``(N, H, W, 3)`` batch in, uint8 masks ``(N, H, W)`` and an int32 class
histogram ``(N, num_classes)`` out, for every ported model (``unet_vgg``,
``unet_resnet50``, ``self_net``).  ``cuda=True`` (the default) runs on the
card through the hand-written kernels and raises when there is no card;
``cuda=False`` runs on the CPU with the kernels' plain versions.

The single-image API (``detect_image``, ``get_FPS``, ``get_miou_png``) is
not ported yet.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from tpu_unet_torch.core.precision import cast_params, for_device, normalize_u8
from tpu_unet_torch.kernels.postprocess import final_argmax_hist, masks_and_hist
from tpu_unet_torch.models.registry import MODELS, build_model, init_model
from tpu_unet_torch.nn.resize import resize_bilinear


class Unet:
    _defaults = {
        "model_path": "",
        "num_classes": 21,
        "backbone": "vgg",
        "input_shape": [512, 512],
        "mix_type": 0,
        "cuda": True,          # run on the card; False: CPU, plain versions
        "model": None,         # registry name; None → canonical unet_<backbone>
        "seed": 0,             # weight init seed when model_path is empty
    }

    @classmethod
    def get_defaults(cls, n):
        if n in cls._defaults:
            return cls._defaults[n]
        return f"Unrecognized attribute name '{n}'"

    def __init__(self, **kwargs):
        self.__dict__.update(self._defaults)
        for name, value in kwargs.items():
            setattr(self, name, value)
        if self.cuda and not torch.cuda.is_available():
            raise RuntimeError("Unet(cuda=True) needs a CUDA device; pass "
                               "cuda=False to run on the CPU")
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if self.cuda else torch.device("cpu")
        self.generate()

    def _model_name(self) -> str:
        if self.model:
            return self.model
        name = f"unet_{self.backbone}"
        if name not in MODELS:
            raise ValueError(f"unknown backbone {self.backbone!r}")
        return name

    def generate(self):
        """Build the net and its weights: a torch state dict in reference
        key names from ``model_path`` (loaded strictly), else the seeded
        init of ``models/registry.py``."""
        net = build_model(self._model_name(), self.num_classes)
        if self.model_path:
            sd = torch.load(self.model_path, map_location="cpu",
                            weights_only=True)
            net.load_state_dict(sd, strict=True)
        else:
            init_model(net, self.seed)
        self.net = net.to(self.device).eval()
        self._serving = None

    def _build_serving(self):
        """``(fn, net)`` with ``fn(net, images) -> (masks uint8 (N, H, W),
        hist int32 (N, num_classes))``.  On the card ``net`` holds bf16
        parameters (batch norm as ``core/precision.py`` says) and every
        decoder and head layer runs a hand-written kernel.

        - ``unet_vgg``: the uint8 batch goes straight to the stem kernel;
        - ``unet_vgg`` and ``unet_resnet50`` (the JAX fast path,
          ``wrapper.py:360-383``): the final 1×1 conv, argmax and histogram
          are one kernel over the last features, so the logits are never
          stored;
        - any other model (``self_net``; the JAX generic branch,
          ``wrapper.py:423-444``): logits → float32 → align-corners resize
          to the input size where they differ → argmax → histogram."""
        prec = for_device(self.device)
        net = self.net
        if prec.param_dtype != torch.float32:
            net = cast_params(copy.deepcopy(net), prec.param_dtype)
        num_classes, device = self.num_classes, self.device
        fused_tail = self._model_name() in ("unet_vgg", "unet_resnet50")

        @torch.no_grad()
        def step(net, images):
            imgs = torch.as_tensor(images).to(device)
            if imgs.dtype != torch.uint8:
                x = imgs.to(prec.compute_dtype)
            elif net.backbone == "vgg":
                x = imgs  # the stem kernel reads uint8 and divides by 255
            else:
                x = normalize_u8(imgs, prec.compute_dtype)
            if fused_tail:
                feats = net(x, features_out=True)
                return final_argmax_hist(feats, net.final.weight,
                                         net.final.bias, num_classes)
            logits = net(x).float()
            if logits.shape[1:3] != imgs.shape[1:3]:
                logits = resize_bilinear(logits, imgs.shape[1:3],
                                         align_corners=True)
            return masks_and_hist(logits.argmax(-1), num_classes)

        return step, net

    def serving_step(self):
        """The batched serving step ``(fn, net)``; see :meth:`_build_serving`."""
        if self._serving is None:
            self._serving = self._build_serving()
        return self._serving

    def batch_infer(self, images) -> np.ndarray:
        """(N, H, W, 3) uint8 (or float, scaled to [0, 1] when above 1.5)
        → (N, H, W) int32 masks."""
        fn, net = self.serving_step()
        imgs = np.asarray(images)
        if imgs.dtype != np.uint8:
            imgs = imgs.astype(np.float32)
            if imgs.max() > 1.5:
                imgs = imgs / 255.0
        masks, _ = fn(net, imgs)
        return masks.cpu().numpy().astype(np.int32)
