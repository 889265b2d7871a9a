"""Command-line entry points of the port (counterpart of ``tpu_unet/cli.py``):

    python -m tpu_unet_torch.cli predict --preset ultralight_large_optimized \\
        --model-path ckpt.pth --mode dir_batched --input img/ --output out/
    python -m tpu_unet_torch.cli miou --preset traditional --model-path ckpt.pth \\
        --split val.txt --image-dir JPEGImages --gt-dir SegmentationClass

Everything runs on the card; ``--cpu`` runs on the CPU instead.  The
``train``, ``fold``, ``summary`` and ``export`` subcommands come with their
slices.
"""
from __future__ import annotations

import argparse
import os


def _add_common(p):
    p.add_argument("--model-path", default="")
    p.add_argument("--num-classes", type=int)
    p.add_argument("--input-shape", type=int, nargs=2)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain versions of the kernels)")


def _wrapper_overrides(args):
    over = {"model_path": args.model_path, "cuda": not args.cpu}
    if args.num_classes:
        over["num_classes"] = args.num_classes
    if args.input_shape:
        over["input_shape"] = list(args.input_shape)
    return over


def cmd_predict(args):
    from PIL import Image

    from tpu_unet_torch.configs.infer_presets import build_wrapper
    from tpu_unet_torch.tools import predict as P

    u = build_wrapper(args.preset, **_wrapper_overrides(args),
                      **({"mix_type": args.mix_type} if args.mix_type is not None else {}))
    if args.mode == "dir":
        n = P.predict_dir(u, args.input, args.output, save_npy=args.save_npy)
        print(f"processed {n} images -> {args.output}")
    elif args.mode == "dir_batched":
        n = P.predict_dir_batched(u, args.input, args.output, batch_size=args.batch_size)
        print(f"processed {n} images -> {args.output}")
    elif args.mode == "single":
        out_path = args.output
        if not os.path.splitext(out_path)[1]:
            out_path += ".jpg"  # PIL picks the format from the extension
        u.detect_image(Image.open(args.input), count=args.count).save(out_path)
        print(f"saved {out_path}")
    elif args.mode == "video":
        # a numeric --input selects a camera index (reference: predict.py:118)
        src = int(args.input) if args.input.isdigit() else args.input
        frames, fps = P.predict_video(u, src, args.output)
        print(f"{frames} frames, {fps:.1f} fps")
    elif args.mode == "fps":
        P.fps_test(u, args.input, args.test_interval)


def cmd_miou(args):
    from tpu_unet_torch.configs.infer_presets import build_wrapper
    from tpu_unet_torch.data.datasets import read_split
    from tpu_unet_torch.eval.driver import evaluate

    u = build_wrapper(args.preset, **_wrapper_overrides(args))
    evaluate(u, read_split(args.split), args.gt_dir, u.num_classes,
             name_classes=args.names.split(",") if args.names else None,
             image_dir=args.image_dir, pred_dir=args.pred_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu_unet_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict")
    p.add_argument("--preset", required=True)
    p.add_argument("--mode", default="dir",
                   choices=["dir", "dir_batched", "single", "video", "fps"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="out")
    p.add_argument("--mix-type", type=int, default=None)
    p.add_argument("--count", action="store_true")
    p.add_argument("--save-npy", action="store_true")
    p.add_argument("--test-interval", type=int, default=100)
    _add_common(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("miou")
    p.add_argument("--preset", required=True)
    p.add_argument("--split", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--pred-dir", default="")
    p.add_argument("--names", default="")
    _add_common(p)
    p.set_defaults(fn=cmd_miou)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
