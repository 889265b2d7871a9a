"""Host-side image transforms (counterpart of ``tpu_unet/data/transforms.py``):
the RGB conversion and the letterbox of the single-image API (reference:
utils/utils.py:12-34), the image + label letterbox of the evaluation
samples, the VOC training augmentation (reference:
utils/dataloader.py:66-137) and the heavy augmentation suite of the DataB
presets (:func:`heavy_aug`, reference: utils/dataloader.py:156-180), with
the same PIL and cv2 calls driven by the same ``np.random.RandomState``
draws in the same order as JAX's, so a sample is byte-equal.  PIL and cv2
are imported inside the functions, so importing the port needs neither."""
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


# ---------------------------------------------------------------------------
# The heavy augmentation suite (albumentations-equivalent, cv2 / numpy);
# probabilities as utils/dataloader.py:156-180.  Every draw of ``rng`` is
# made in JAX's order, so the same state gives the same bytes.
# ---------------------------------------------------------------------------

def _shift_scale_rotate(img, lbl, rng, shift=0.0625, scale=0.1, rot=45):
    import cv2

    h, w = img.shape[:2]
    angle = rng.uniform(-rot, rot)
    s = 1 + rng.uniform(-scale, scale)
    tx = rng.uniform(-shift, shift) * w
    ty = rng.uniform(-shift, shift) * h
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, s)
    m[0, 2] += tx
    m[1, 2] += ty
    img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT_101)
    lbl = cv2.warpAffine(lbl, m, (w, h), flags=cv2.INTER_NEAREST,
                         borderMode=cv2.BORDER_REFLECT_101)
    return img, lbl


def _remap(img, lbl, mx, my):
    import cv2

    img = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT_101)
    lbl = cv2.remap(lbl, mx, my, cv2.INTER_NEAREST, borderMode=cv2.BORDER_REFLECT_101)
    return img, lbl


def _elastic(img, lbl, rng, alpha=1.0, sigma=50.0):
    import cv2
    import numpy as np

    h, w = img.shape[:2]
    dx = cv2.GaussianBlur((rng.rand(h, w).astype(np.float32) * 2 - 1), (0, 0), sigma) * alpha
    dy = cv2.GaussianBlur((rng.rand(h, w).astype(np.float32) * 2 - 1), (0, 0), sigma) * alpha
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    return _remap(img, lbl, (xx + dx).astype(np.float32), (yy + dy).astype(np.float32))


def _grid_distortion(img, lbl, rng, num_steps=5, distort=0.3):
    import numpy as np

    h, w = img.shape[:2]

    def axis_map(size):
        steps = 1 + rng.uniform(-distort, distort, num_steps + 1)
        xs = np.linspace(0, size, num_steps + 1)
        cur = 0.0
        prev = 0.0
        mapping = np.zeros(size, np.float32)
        for i in range(num_steps):
            start, end = int(xs[i]), int(xs[i + 1])
            seg = (end - start) * steps[i]
            mapping[start:end] = np.linspace(cur, cur + seg, max(end - start, 1),
                                             endpoint=False)
            cur += seg
            prev = end
        if prev < size:
            mapping[prev:] = cur
        return mapping * (size - 1) / max(mapping[-1], 1e-6)

    mx = np.tile(axis_map(w)[None, :], (h, 1))
    my = np.tile(axis_map(h)[:, None], (1, w))
    return _remap(img, lbl, mx, my)


def _optical_distortion(img, lbl, rng, distort=0.5, shift=0.5):
    import cv2
    import numpy as np

    h, w = img.shape[:2]
    k = rng.uniform(-distort, distort)
    dx = rng.uniform(-shift, shift)
    dy = rng.uniform(-shift, shift)
    cam = np.array([[w, 0, w / 2 + dx], [0, h, h / 2 + dy], [0, 0, 1]], np.float32)
    dist = np.array([k, k, 0, 0, 0], np.float32)
    mx, my = cv2.initUndistortRectifyMap(cam, dist, None, None, (w, h), cv2.CV_32FC1)
    return _remap(img, lbl, mx, my)


def _clahe(img, rng):
    import cv2

    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    clahe = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
    lab[..., 0] = clahe.apply(lab[..., 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


def _sharpen(img, rng):
    import cv2

    alpha = rng.uniform(0.2, 0.5)
    blur = cv2.GaussianBlur(img, (0, 0), 3)
    return cv2.addWeighted(img, 1 + alpha, blur, -alpha, 0)


def _emboss(img, rng):
    import cv2
    import numpy as np

    kernel = np.array([[-1, -1, 0], [-1, 1, 1], [0, 1, 1]], np.float32)
    emb = cv2.filter2D(img, -1, kernel)
    alpha = rng.uniform(0.2, 0.5)
    return cv2.addWeighted(img, 1 - alpha, emb, alpha, 0)


def heavy_aug(img, lbl, rng):
    """The heavy suite on uint8 HWC ``img`` and HW ``lbl`` (reference:
    utils/dataloader.py:156-180): HFlip / VFlip / Rotate90 (0.5 each); one of
    ShiftScaleRotate, Elastic, Grid, Optical distortion (0.5); Gauss or
    multiplicative noise (0.3); motion, median or box blur (0.3); CLAHE,
    Sharpen or Emboss (0.3).  ``rng`` is an ``np.random.RandomState``.
    Without cv2 the sample passes unchanged, as JAX's."""
    import numpy as np

    try:
        import cv2
    except ImportError:
        return img, lbl
    if rng.rand() < 0.5:
        img, lbl = img[:, ::-1].copy(), lbl[:, ::-1].copy()
    if rng.rand() < 0.5:
        img, lbl = img[::-1].copy(), lbl[::-1].copy()
    if rng.rand() < 0.5:
        k = rng.randint(1, 4)
        img, lbl = np.rot90(img, k).copy(), np.rot90(lbl, k).copy()

    if rng.rand() < 0.5:
        geometric = (_shift_scale_rotate, _elastic, _grid_distortion, _optical_distortion)
        img, lbl = geometric[rng.randint(4)](img, lbl, rng)

    if rng.rand() < 0.3:
        if rng.rand() < 0.5:
            noise = rng.normal(0, rng.uniform(3, 7), img.shape)
            img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
        else:
            mult = rng.uniform(0.9, 1.1, (1, 1, img.shape[2]))
            img = np.clip(img.astype(np.float32) * mult, 0, 255).astype(np.uint8)

    if rng.rand() < 0.3:
        choice = rng.randint(3)
        k = int(rng.choice([3, 5]))
        if choice == 0:  # motion blur
            kern = np.zeros((k, k), np.float32)
            kern[k // 2, :] = 1.0 / k
            img = cv2.filter2D(img, -1, kern)
        elif choice == 1:
            img = cv2.medianBlur(img, k)
        else:
            img = cv2.blur(img, (k, k))

    if rng.rand() < 0.3:
        img = (_clahe, _sharpen, _emboss)[rng.randint(3)](img, rng)
    return img, lbl
