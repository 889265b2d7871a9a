"""The ``Unet`` inference wrapper of the port (counterpart of
``tpu_unet/infer/wrapper.py``): the batched serving step and the reference's
single-image API, for every model of the registry (``models/registry.py``,
the JAX package's 18; a ``repvgg_segnet`` checkpoint in its folded deploy
form builds the ``deploy=True`` model).

``cuda=True`` (the default) runs on the card through the hand-written
kernels and raises when there is no card; ``cuda=False`` runs on the CPU
with the kernels' plain versions.

- Serving (:meth:`Unet.serving_step`, :meth:`Unet.batch_infer`): a uint8
  ``(N, H, W, 3)`` batch in, uint8 masks ``(N, H, W)`` and an int32 class
  histogram ``(N, num_classes)`` out.
- Single image (:meth:`Unet.detect_image`, :meth:`Unet.get_miou_png`,
  :meth:`Unet.get_FPS`; reference: unet.py:101-344): RGB → BICUBIC
  letterbox on a gray canvas → the ``normalize_images`` kernel → forward →
  float32 logits → softmax → crop of the gray bars → bilinear resize of the
  probabilities to the original size (cv2 ``INTER_LINEAR``) → argmax →
  palette, blend or background removal.  ``fast=True`` and ``get_FPS``
  crop and argmax on the device, so only a uint8 mask leaves it.

Precision (``core/precision.py::for_device``): on the card bf16 parameters
and activations with float32 accumulation in every kernel, on both paths —
the port's VGG kernels take bf16 only, and on the TPU the JAX single-image
forward's float32 convolutions run at default precision, which is bf16
passes.  On the CPU everything is float32, as JAX on the CPU is.
"""
from __future__ import annotations

import colorsys
import copy
import functools
import time

import numpy as np
import torch

from tpu_unet_torch.core.precision import cast_params, for_device, normalize_u8
from tpu_unet_torch.data.transforms import cvt_rgb, letterbox_image
from tpu_unet_torch.infer.convert import load_state_dict, read_state_dict
from tpu_unet_torch.kernels.postprocess import (HIST_BLOCK, argmax_mask,
                                                final_argmax, final_argmax_hist,
                                                masks_and_hist)
from tpu_unet_torch.kernels.preprocess import normalize_images
from tpu_unet_torch.models.registry import MODELS, build_model, init_model
from tpu_unet_torch.models.traditional import TraditionalUnet
from tpu_unet_torch.nn.resize import resize_bilinear

# VOC 21-color palette + gray (reference: unet.py:67-71)
VOC_COLORS = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (192, 0, 0),
    (64, 128, 0), (192, 128, 0), (64, 0, 128), (192, 0, 128), (64, 128, 128),
    (192, 128, 128), (0, 64, 0), (128, 64, 0), (0, 192, 0), (128, 192, 0),
    (0, 64, 128), (128, 64, 12),
]

# the row block of the JAX natural-layout tail (postprocess.py:146-152):
# a TraditionalUnet image whose pixel count it divides takes the histogram
# kernel, any other the mask-only kernel and a separate histogram
_TAIL_ROWS = 1024


def input_res_logits(logits, size) -> torch.Tensor:
    """A net's output → float32 logits at the input's ``size`` (H, W): a
    tuple's first element (a model that also returns heads), and an
    align-corners resize where the logits are at another size (self_net
    ×2), as ``wrapper.py:144-152``."""
    if isinstance(logits, (tuple, list)):
        logits = logits[0]
    logits = logits.float()
    if tuple(logits.shape[1:3]) != tuple(size):
        logits = resize_bilinear(logits, tuple(size), align_corners=True)
    return logits


@functools.lru_cache(maxsize=None)
def _cv2():
    """OpenCV where it imports, else None: the JAX wrapper's choice of
    resize (wrapper.py:35-38, 210-218)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


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
        if self.num_classes <= 21:
            self.colors = list(VOC_COLORS)
        else:
            hsv = [(x / self.num_classes, 1.0, 1.0)
                   for x in range(self.num_classes)]
            self.colors = [tuple(int(c * 255) for c in colorsys.hsv_to_rgb(*t))
                           for t in hsv]
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if self.cuda else torch.device("cpu")
        self.prec = for_device(self.device)
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
        key names from ``model_path`` (``infer/convert.py::load_state_dict``:
        strict but for ``num_batches_tracked``, an EarlyStopping wrapper
        unwrapped), else the seeded init of ``models/registry.py``.  Weights
        with a ``reparam`` conv (``cli fold``'s output) build the deploy
        form."""
        name = self._model_name()
        sd = read_state_dict(self.model_path) if self.model_path else None
        kwargs = {"deploy": True} if sd is not None and any(
            ".reparam." in k for k in sd) else {}
        net = build_model(name, self.num_classes, **kwargs)
        if sd is not None:
            load_state_dict(net, sd, name)
        else:
            init_model(net, self.seed)
        self.net = net.to(self.device).eval()
        self._compute_net = None
        self._serving = None

    def _net(self):
        """``self.net`` in the compute precision, made once: on the card a
        copy with bf16 parameters (batch norm as ``core/precision.py``
        says), on the CPU the float32 net itself."""
        if self._compute_net is None:
            net = self.net
            if self.prec.param_dtype != torch.float32:
                net = cast_params(copy.deepcopy(net), self.prec.param_dtype)
            self._compute_net = net
        return self._compute_net

    # ------------------------------------------------------------------
    # single image

    @torch.no_grad()
    def _forward_logits(self, x) -> torch.Tensor:
        """Letterboxed uint8 ``(1, H, W, 3)`` (host array or tensor) →
        float32 logits ``(1, H, W, C)`` at the input resolution on the
        device."""
        x = torch.as_tensor(x).to(self.device)
        return input_res_logits(self._net()(normalize_images(x, self.prec.compute_dtype)),
                                x.shape[1:3])

    def _forward_probs(self, x) -> torch.Tensor:
        """Float32 class probabilities ``(1, H, W, C)`` on the device: the
        softmax of :meth:`_forward_logits` (reference: wrapper.py:130-153)."""
        return torch.softmax(self._forward_logits(x), dim=-1)

    def _letterbox(self, image):
        """(uint8 ``(1, H, W, 3)`` host array, nw, nh, RGB image)."""
        image = cvt_rgb(image)
        boxed, nw, nh = letterbox_image(image, self.input_shape)
        return np.array(boxed, np.uint8)[None], nw, nh, image

    def _crop(self, pr, nh: int, nw: int):
        """Crop the gray letterbox bars of an ``(H, W, ...)`` map
        (reference: unet.py:139-140)."""
        oh, ow = self.input_shape
        y0, x0 = (oh - nh) // 2, (ow - nw) // 2
        return pr[y0:y0 + nh, x0:x0 + nw]

    def _probs_for(self, image):
        """(cropped float32 probabilities (nh, nw, C) on the host, RGB image)."""
        x, nw, nh, image = self._letterbox(image)
        pr = self._forward_probs(x)[0].cpu().numpy()
        return self._crop(pr, nh, nw), image

    def _mask_for(self, x, nh: int, nw: int) -> np.ndarray:
        """Letterboxed uint8 ``(1, H, W, 3)`` → uint8 mask (nh, nw): forward,
        crop and argmax on the device, so only the mask crosses to the host.
        Per pixel, the argmax of the probabilities is that of the logits."""
        pr = self._crop(self._forward_probs(x)[0], nh, nw)
        return pr.argmax(dim=-1).to(torch.uint8).cpu().numpy()

    def _device_mask_for(self, image):
        """(uint8 mask (nh, nw) at input resolution, RGB image)."""
        x, nw, nh, image = self._letterbox(image)
        return self._mask_for(x, nh, nw), image

    def _resize_probs(self, pr, orig_w: int, orig_h: int) -> np.ndarray:
        """cv2 INTER_LINEAR prob-map resize (reference: unet.py:144)."""
        cv2 = _cv2()
        if cv2 is not None:
            return cv2.resize(pr, (orig_w, orig_h), interpolation=cv2.INTER_LINEAR)
        return resize_bilinear(torch.from_numpy(np.ascontiguousarray(pr)),
                               (orig_h, orig_w), align_corners=False).numpy()

    def _mask_resized(self, image, orig_w: int, orig_h: int):
        """Device mask + nearest resize to the original size: the
        ``fast=True`` path.  Resizing the mask instead of the
        probabilities moves class boundaries by under a pixel and ships a
        uint8 mask instead of the float32 map."""
        mask, image = self._device_mask_for(image)
        if (orig_h, orig_w) != mask.shape:
            cv2 = _cv2()
            if cv2 is not None:
                mask = cv2.resize(mask, (orig_w, orig_h),
                                  interpolation=cv2.INTER_NEAREST)
            else:
                from PIL import Image

                mask = np.asarray(Image.fromarray(mask).resize(
                    (orig_w, orig_h), Image.NEAREST))
        return mask.astype(np.int64), image

    def detect_image(self, image, count: bool = False, name_classes=None,
                     fast: bool = False):
        """PIL image → rendered PIL image at its size (reference:
        unet.py:101-203): ``mix_type`` 0 blends the palette mask at 0.7,
        1 is the palette mask, 2 keeps the foreground pixels."""
        from PIL import Image

        old_img = image.copy()
        orig_w, orig_h = image.size
        if fast:
            mask, image = self._mask_resized(image, orig_w, orig_h)
        else:
            pr, image = self._probs_for(image)
            mask = self._resize_probs(pr, orig_w, orig_h).argmax(axis=-1)

        if count:
            classes_nums = np.zeros(self.num_classes, np.int64)
            total = orig_h * orig_w
            print("-" * 63)
            print("|%25s | %15s | %15s|" % ("Key", "Value", "Ratio"))
            print("-" * 63)
            for i in range(self.num_classes):
                num = int((mask == i).sum())
                ratio = num / total * 100
                if num > 0:
                    name = name_classes[i] if name_classes else str(i)
                    print("|%25s | %15s | %14.2f%%|" % (name, num, ratio))
                    print("-" * 63)
                classes_nums[i] = num
            print("classes_nums:", classes_nums)

        if self.mix_type in (0, 1):
            seg = np.asarray(self.colors, np.uint8)[
                mask.reshape(-1) % len(self.colors)].reshape(orig_h, orig_w, 3)
            if self.mix_type == 1:
                return Image.fromarray(seg)
            return Image.blend(cvt_rgb(old_img), Image.fromarray(seg), 0.7)
        # mix_type 2: background removal (reference: unet.py:196-201)
        arr = np.asarray(cvt_rgb(old_img))
        return Image.fromarray((arr * (mask[..., None] != 0)).astype(np.uint8))

    def get_miou_png(self, image, fast: bool = False):
        """Class-index PNG at the original size (reference: unet.py:298-344);
        ``fast=True``: device mask + nearest resize."""
        from PIL import Image

        orig_w, orig_h = image.size
        if fast:
            mask, _ = self._mask_resized(image, orig_w, orig_h)
            return Image.fromarray(mask.astype(np.uint8))
        pr, _ = self._probs_for(image)
        pr = self._resize_probs(pr, orig_w, orig_h)
        return Image.fromarray(pr.argmax(axis=-1).astype(np.uint8))

    def convert_to_export(self, path: str):
        """The ``torch.export`` program of the float32 forward + softmax at
        ``path`` (``tools/export.py::export_program``), the counterpart of
        the JAX wrapper's StableHLO export (``wrapper.py:510``) and of the
        reference's ``convert_to_onnx`` (unet.py:260-296)."""
        from tpu_unet_torch.tools.export import export_program

        return export_program(self, path)

    def get_FPS(self, image, test_interval: int, full_d2h: bool = False) -> float:
        """Seconds per image of the timed forward + softmax + crop + argmax
        loop (reference: unet.py:205-258), host upload included.  By
        default crop and argmax run on the device and only the uint8 mask
        comes back; ``full_d2h=True`` ships the float32 probability map to
        the host and argmaxes there, as the reference does."""
        x, nw, nh, _ = self._letterbox(image)
        if full_d2h:
            def once():
                pr = self._forward_probs(x)[0].cpu().numpy()
                return self._crop(pr, nh, nw).argmax(axis=-1)
        else:
            def once():
                return self._mask_for(x, nh, nw)

        once()  # warm-up: kernel build, cuDNN plans
        t0 = time.time()
        for _ in range(test_interval):
            once()
        return (time.time() - t0) / test_interval

    # ------------------------------------------------------------------
    # batched serving

    def _build_serving(self):
        """``(fn, net)`` with ``fn(net, images) -> (masks uint8 (N, H, W),
        hist int32 (N, num_classes))``.  ``net`` is :meth:`_net`; uint8
        images are divided by 255 in the compute dtype
        (``core/precision.py::normalize_u8``, as ``wrapper.py:411-413``).

        - ``unet_vgg``: the uint8 batch goes straight to the stem kernel;
        - ``unet_vgg``, ``unet_resnet50`` (the JAX fast path,
          ``wrapper.py:360-383``) and ``traditional``, ``traditional22``
          (the JAX natural-layout tail, ``wrapper.py:385-421``, on by
          default on the accelerator): the final 1×1 conv (``final``,
          ``outc``), argmax and histogram are one kernel over the last
          features, so the logits are never stored — when the image's
          pixel count is a multiple of the kernel's block (256 pixels; for
          the TraditionalUnet family JAX's 1024-row block,
          ``postprocess.py:146-152``); else the mask-only kernel and a
          separate histogram;
        - any other model (``self_net``, the ladder models, ``lightweight``
          and the other eight registry models; the JAX generic branch,
          ``wrapper.py:423-444``, a tuple's first element): logits (where
          their size is not the input's: → float32 → align-corners resize)
          → the ``argmax_mask`` kernel, which compares in float32 and
          writes the uint8 mask → histogram.  JAX's ladder fused tail is opt-in only
          (``wrapper.py:398-400``), so the ladder models take this branch,
          as they do in JAX by default."""
        prec = self.prec
        net = self._net()
        num_classes, device = self.num_classes, self.device
        final_name = "outc" if isinstance(net, TraditionalUnet) else "final"
        fused_tail = final_name == "outc" or \
            self._model_name() in ("unet_vgg", "unet_resnet50")
        tail_rows = _TAIL_ROWS if final_name == "outc" else HIST_BLOCK

        @torch.no_grad()
        def step(net, images):
            imgs = torch.as_tensor(images).to(device)
            if imgs.dtype != torch.uint8:
                x = imgs.to(prec.compute_dtype)
            elif getattr(net, "backbone", None) == "vgg":
                x = imgs  # the stem kernel reads uint8 and divides by 255
            else:
                x = normalize_u8(imgs, prec.compute_dtype)
            if fused_tail:
                feats = net(x, features_out=True)
                final = getattr(net, final_name)
                if (feats.shape[1] * feats.shape[2]) % tail_rows == 0:
                    return final_argmax_hist(feats, final.weight, final.bias,
                                             num_classes)
                return masks_and_hist(final_argmax(feats, final.weight, final.bias,
                                                   num_classes), num_classes)
            logits = net(x)
            if isinstance(logits, (tuple, list)):
                logits = logits[0]
            if logits.shape[1:3] != imgs.shape[1:3]:
                logits = resize_bilinear(logits.float(), imgs.shape[1:3],
                                         align_corners=True)
            return masks_and_hist(argmax_mask(logits.contiguous(), torch.uint8),
                                  num_classes)

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
