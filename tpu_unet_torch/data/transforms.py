"""Host-side image transforms (counterpart of ``tpu_unet/data/transforms.py``):
the RGB conversion and the letterbox of the single-image API (reference:
utils/utils.py:12-34), the image + label letterbox of the evaluation
samples and the VOC training augmentation (reference:
utils/dataloader.py:66-137), with the same PIL and cv2 calls driven by the
same ``np.random.RandomState`` as JAX's, so a sample is byte-equal.  PIL and
cv2 are imported inside the functions, so importing the port needs
neither.  The heavy augmentation suite comes with the DataB training
slice."""
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


def letterbox_pair(image, label, size):
    """Image + label letterbox (reference: utils/dataloader.py:66-79): the
    image as :func:`letterbox_image`, the label NEAREST-resized and pasted
    on a 0 canvas.  ``size`` = (h, w)."""
    from PIL import Image

    h, w = size
    new_image, nw, nh = letterbox_image(image, size)
    label = label.resize((nw, nh), Image.NEAREST)
    new_label = Image.new("L", (w, h), 0)
    new_label.paste(label, ((w - nw) // 2, (h - nh) // 2))
    return new_image, new_label


def random_voc_aug(image, label, size, rng, jitter=0.3, hue=0.1, sat=0.7, val=0.3):
    """The VOC geometric + HSV augmentation (reference:
    utils/dataloader.py:84-137): aspect jitter, scale 0.25-2, 50% flip, a
    random paste on gray, HSV jitter through cv2 lookup tables.  ``rng`` is
    an ``np.random.RandomState``; returns uint8 arrays (image, label)."""
    import numpy as np
    from PIL import Image

    try:
        import cv2
    except ImportError:  # the JAX transform skips the HSV jitter too
        cv2 = None

    def rand(a=0.0, b=1.0):
        return rng.rand() * (b - a) + a

    image = cvt_rgb(image)
    iw, ih = image.size
    h, w = size
    new_ar = iw / ih * rand(1 - jitter, 1 + jitter) / rand(1 - jitter, 1 + jitter)
    scale = rand(0.25, 2)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)
    image = image.resize((nw, nh), Image.BICUBIC)
    label = label.resize((nw, nh), Image.NEAREST)
    if rand() < 0.5:
        image = image.transpose(Image.FLIP_LEFT_RIGHT)
        label = label.transpose(Image.FLIP_LEFT_RIGHT)
    dx = int(rand(0, w - nw))
    dy = int(rand(0, h - nh))
    new_image = Image.new("RGB", (w, h), (128, 128, 128))
    new_label = Image.new("L", (w, h), 0)
    new_image.paste(image, (dx, dy))
    new_label.paste(label, (dx, dy))

    image_data = np.array(new_image, np.uint8)
    if cv2 is not None:
        r = rng.uniform(-1, 1, 3) * np.array([hue, sat, val]) + 1
        hsv = cv2.cvtColor(image_data, cv2.COLOR_RGB2HSV)
        hch, sch, vch = cv2.split(hsv)
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(np.uint8)
        lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
        lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
        image_data = cv2.merge((cv2.LUT(hch, lut_hue), cv2.LUT(sch, lut_sat),
                                cv2.LUT(vch, lut_val)))
        image_data = cv2.cvtColor(image_data, cv2.COLOR_HSV2RGB)
    return image_data, np.array(new_label, np.uint8)
