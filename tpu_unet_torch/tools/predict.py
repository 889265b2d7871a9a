"""Prediction entry points (counterpart of ``tpu_unet/tools/predict.py``;
reference: predict.py:13-194): a folder one image at a time, a folder in
fixed-shape batches, a video frame by frame or in batches, and the FPS test.

On the card the batched video path blends the palette on the device with
the ``mask_palette`` kernel when the frame size equals the model size; every
other case, and every run on the CPU, renders on the host with
:func:`render`, which gives the same bytes.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import time
from typing import Optional

import numpy as np

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _image_names(in_dir: str, limit: Optional[int]):
    names = sorted(f for f in os.listdir(in_dir) if f.lower().endswith(_IMAGE_EXTS))
    return names[:limit] if limit else names


def predict_dir(wrapper, in_dir: str, out_dir: str, save_npy: bool = False,
                limit: Optional[int] = None) -> int:
    """``detect_image`` over a folder, saving ``seg_<name>.jpg`` (and the
    class map as ``.npy`` with ``save_npy``) (reference: predict.py:77-112,
    :166-178).  Returns the number of images."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    names = _image_names(in_dir, limit)
    for name in names:
        image = Image.open(os.path.join(in_dir, name))
        stem = "seg_" + os.path.splitext(name)[0]
        wrapper.detect_image(image).save(os.path.join(out_dir, stem + ".jpg"))
        if save_npy:
            np.save(os.path.join(out_dir, stem), np.asarray(wrapper.get_miou_png(image)))
    return len(names)


def predict_dir_batched(wrapper, in_dir: str, out_dir: str, batch_size: int = 32,
                        n_threads: int = 8, limit: Optional[int] = None) -> int:
    """Folder segmentation in fixed-shape batches: native letterbox decode
    (``data/native.py``) of the next chunk in a background thread while the
    device runs this one, the last chunk padded to ``batch_size``,
    ``batch_infer``, one class-index PNG (``<stem>.png``, at the model's
    size) per image.  Returns the number of images."""
    from PIL import Image

    from tpu_unet_torch.data.native import load_letterbox_batch

    os.makedirs(out_dir, exist_ok=True)
    names = _image_names(in_dir, limit)
    h, w = wrapper.input_shape

    def load_chunk(chunk):
        batch, _, _ = load_letterbox_batch([os.path.join(in_dir, n) for n in chunk],
                                           h, w, n_threads)
        if len(chunk) < batch_size:  # pad to the fixed batch
            pad = np.zeros((batch_size - len(chunk), h, w, 3), np.uint8)
            batch = np.concatenate([batch, pad])
        return batch

    chunks = [names[i:i + batch_size] for i in range(0, len(names), batch_size)]
    done = 0
    with cf.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(load_chunk, chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            batch = nxt.result()
            if ci + 1 < len(chunks):
                nxt = pool.submit(load_chunk, chunks[ci + 1])
            masks = wrapper.batch_infer(batch)[: len(chunk)]
            for name, mask in zip(chunk, masks):
                Image.fromarray(mask.astype(np.uint8)).save(
                    os.path.join(out_dir, os.path.splitext(name)[0] + ".png"))
            done += len(chunk)
    return done


def _video_writer(path: str, fps: float, size):
    import cv2

    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), fps, size)
    if not out.isOpened():
        raise RuntimeError(f"cv2 cannot write an XVID video to {path!r}")
    return out


def predict_video(wrapper, video_path=0, video_save_path: str = "",
                  video_fps: float = 25.0, max_frames: Optional[int] = None):
    """``detect_image`` frame by frame with a running-average FPS overlay
    (reference: predict.py:115-159).  Returns (frames, last fps)."""
    import cv2
    from PIL import Image

    capture = cv2.VideoCapture(video_path)
    out = None
    if video_save_path:
        size = (int(capture.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        out = _video_writer(video_save_path, video_fps, size)
    fps = 0.0
    frames = 0
    while True:
        t1 = time.time()
        ok, frame = capture.read()
        if not ok:
            break
        frame_rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        result = np.array(wrapper.detect_image(Image.fromarray(frame_rgb)))
        result = cv2.cvtColor(result, cv2.COLOR_RGB2BGR)
        fps = (fps + (1.0 / max(time.time() - t1, 1e-6))) / 2
        result = cv2.putText(result, f"fps= {fps:.2f}", (0, 40),
                             cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
        if out is not None:
            out.write(result)
        frames += 1
        if max_frames and frames >= max_frames:
            break
    capture.release()
    if out is not None:
        out.release()
    return frames, fps


def render(frame: np.ndarray, mask: np.ndarray, colors: np.ndarray, alpha: float,
           box, size) -> np.ndarray:
    """Host render of one frame: crop the letterbox bars
    (``box = (dx, dy, nw, nh)``), nearest-resize the mask to the frame's
    ``size = (w, h)``, palette, blend ``frame·(1−α) + seg·α`` in float32
    and round half to even.  (1 − α) is taken in float32, as the kernel
    takes it; for α = 0.7 that is the JAX render's float too."""
    import cv2

    dx, dy, nw, nh = box
    content = np.ascontiguousarray(mask[dy:dy + nh, dx:dx + nw], np.uint8)
    mask_full = cv2.resize(content, size, interpolation=cv2.INTER_NEAREST)
    seg = colors[mask_full % len(colors)]
    a = np.float32(alpha)
    blended = frame.astype(np.float32) * (np.float32(1.0) - a) + seg.astype(np.float32) * a
    return np.round(blended).astype(np.uint8)


def predict_video_batched(wrapper, video_path, video_save_path: str,
                          batch_size: int = 8, video_fps: float = 25.0,
                          max_frames: Optional[int] = None, alpha: float = 0.7) -> int:
    """Streaming video inference in fixed-shape batches: frames are read and
    converted in a background thread, letterboxed on the host (cv2 bilinear
    on a gray canvas), run through the serving step, and written back
    blended at their own size.  On the card with the frame size equal to
    the model size the masks never leave the device: the ``mask_palette``
    kernel blends them with the frames there; otherwise :func:`render`
    blends on the host.  Returns the number of frames written."""
    import cv2
    import torch

    from tpu_unet_torch.kernels.render import mask_palette, palette_tensor

    h, w = wrapper.input_shape
    capture = cv2.VideoCapture(video_path)
    if not capture.isOpened():
        raise RuntimeError(f"cv2 cannot read the video {video_path!r}")
    ow = int(capture.get(cv2.CAP_PROP_FRAME_WIDTH))
    oh = int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out = _video_writer(video_save_path, video_fps, (ow, oh))
    colors = np.asarray(wrapper.colors, np.uint8)
    on_device = wrapper.device.type == "cuda" and (oh, ow) == (h, w)
    palette = palette_tensor(colors, wrapper.device) if on_device else None

    scale = min(w / ow, h / oh)
    nw, nh = int(ow * scale), int(oh * scale)
    dx, dy = (w - nw) // 2, (h - nh) // 2

    def letterbox(frame):
        resized = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR)
        canvas = np.full((h, w, 3), 128, np.uint8)
        canvas[dy:dy + nh, dx:dx + nw] = resized
        return canvas

    def read_batch():
        frames = []
        while len(frames) < batch_size:
            ok, frame = capture.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        return frames

    done = 0
    with cf.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(read_batch)
        while True:
            frames = nxt.result()
            if not frames:
                break
            nxt = pool.submit(read_batch)  # decode the next batch meanwhile
            batch = np.stack([letterbox(f) for f in frames])
            if len(frames) < batch_size:
                pad = np.zeros((batch_size - len(frames), h, w, 3), np.uint8)
                batch = np.concatenate([batch, pad])
            if on_device:
                fn, net = wrapper.serving_step()
                masks, _ = fn(net, batch)
                imgs = torch.from_numpy(np.stack(frames)).to(wrapper.device)
                blended = mask_palette(masks[: len(frames)], imgs, palette, alpha).cpu().numpy()
            else:
                masks = wrapper.batch_infer(batch)[: len(frames)]
                blended = [render(f, m, colors, alpha, (dx, dy, nw, nh), (ow, oh))
                           for f, m in zip(frames, masks)]
            for fr in blended:
                out.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            done += len(frames)
            if max_frames and done >= max_frames:
                break
    capture.release()
    out.release()
    return done


def fps_test(wrapper, image_path: str, test_interval: int = 100) -> float:
    """Seconds per image of ``get_FPS`` at batch 1, printed as FPS
    (reference: predict.py:161-164).  Returns the FPS."""
    from PIL import Image

    tact = wrapper.get_FPS(Image.open(image_path), test_interval)
    print(f"{tact:.6f} seconds, {1 / tact:.2f} FPS, @batch_size 1")
    return 1.0 / tact
