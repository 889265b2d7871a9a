"""Host-side image transforms of the single-image API (counterpart of
``tpu_unet/data/transforms.py``): the RGB conversion and the letterbox
(reference: utils/utils.py:12-34).  PIL is imported inside the functions,
so importing the port does not need it."""
from __future__ import annotations


def cvt_rgb(image):
    """PIL image → RGB (reference: utils/utils.py:12-17)."""
    if image.mode == "RGB":
        return image
    return image.convert("RGB")


def letterbox_image(image, size):
    """Aspect-preserving BICUBIC resize + centred paste on a gray(128)
    canvas (reference: utils/utils.py:22-34).  ``size`` = (h, w); returns
    (canvas, nw, nh)."""
    from PIL import Image

    h, w = size
    iw, ih = image.size
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    resized = image.resize((nw, nh), Image.BICUBIC)
    canvas = Image.new("RGB", (w, h), (128, 128, 128))
    canvas.paste(resized, ((w - nw) // 2, (h - nh) // 2))
    return canvas, nw, nh
