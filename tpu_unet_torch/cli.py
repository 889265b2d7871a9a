"""Command-line entry points of the port (counterpart of ``tpu_unet/cli.py``):

    python -m tpu_unet_torch.cli train --preset train_py --no-pretrained \\
        --data-root /data --epochs 2
    python -m tpu_unet_torch.cli predict --preset ultralight_large_optimized \\
        --model-path ckpt.pth --mode dir_batched --input img/ --output out/
    python -m tpu_unet_torch.cli miou --preset traditional --model-path ckpt.pth \\
        --split val.txt --image-dir JPEGImages --gt-dir SegmentationClass

    python -m tpu_unet_torch.cli train --preset traditional --data-root /data
    python -m tpu_unet_torch.cli fold --model-path repvgg.pth --out deploy.pth
    python -m tpu_unet_torch.cli summary --model unet_vgg --size 512
    python -m tpu_unet_torch.cli export --preset voc_vgg --model-path ckpt.pth \
        --out unet_vgg.pt2

Everything runs on the card; ``--cpu`` runs on the CPU instead.
``--model`` puts any registry model in the preset's place (``predict``,
``miou``, ``train``).  ``fold`` writes a ``repvgg_segnet`` checkpoint's
deploy form (``models/repvgg.py::fold_repvgg``), which ``predict`` and
``miou`` serve as they find it.  ``summary`` prints the parameter count (JAX's) and
the FLOPs that ``torch.utils.flop_counter`` counts over the eval forward on
the CPU (``tools/summary.py``; not XLA's count).  ``export`` writes the
float32 forward + softmax as a ``torch.export`` program
(``tools/export.py``) that runs on the device it was exported on: on the
card its graph holds the hand-written kernels as operators.
``train --wandb`` logs through ``wandb`` and raises where it does not
import (nothing is installed or downloaded).
"""
from __future__ import annotations

import argparse
import os


def _add_common(p):
    p.add_argument("--model-path", default="")
    p.add_argument("--model", default="",
                   help="registry model in place of the preset's")
    p.add_argument("--num-classes", type=int)
    p.add_argument("--input-shape", type=int, nargs=2)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain versions of the kernels)")


def _wrapper_overrides(args):
    over = {"model_path": args.model_path, "cuda": not args.cpu}
    if args.model:
        over["model"] = args.model
    if args.num_classes:
        over["num_classes"] = args.num_classes
    if args.input_shape:
        over["input_shape"] = list(args.input_shape)
    return over


def cmd_train(args):
    import dataclasses

    from tpu_unet_torch.configs.presets import get_preset
    from tpu_unet_torch.data.datasets import read_split
    from tpu_unet_torch.train.fit import fit

    if args.wandb:
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise NotImplementedError(f"train --wandb needs the wandb package, which "
                                      f"does not import here ({e}); nothing is "
                                      "installed or downloaded") from e
    overrides = {}
    if args.model:
        overrides["model"] = args.model
    if args.model_path:
        overrides["model_path"] = args.model_path
    if args.num_classes:
        overrides["num_classes"] = args.num_classes
    if args.input_shape:
        overrides["input_shape"] = tuple(args.input_shape)
    if args.epochs:
        overrides["unfreeze_epoch"] = args.epochs
    if args.batch_size:
        overrides["freeze_batch_size"] = args.batch_size
        overrides["unfreeze_batch_size"] = args.batch_size
    if args.data_path:
        overrides["dataset_path"] = args.data_path
    if args.eval_period:
        # an explicit period asks for evaluation, even where the preset has
        # it off
        overrides["eval_period"] = args.eval_period
        overrides["eval_flag"] = True
    if args.save_dir:
        overrides["save_dir"] = args.save_dir
    if args.no_pretrained:
        overrides["pretrained_backbone"] = False
    cfg = get_preset(args.preset, **overrides)

    if args.train_split:
        train_ids = read_split(args.train_split)
        val_ids = read_split(args.val_split) if args.val_split else []
    else:
        # default split layouts (reference: train.py:355-358,
        # train_medical.py:227-230)
        sub = {"voc": "VOC2012", "heavy": "VOC2012", "voc2007": "VOC2007",
               "defect": "DataB", "medical": ""}[cfg.dataset]
        sets = os.path.join(args.data_root, cfg.dataset_path, sub, "ImageSets",
                            "Segmentation")
        train_ids = read_split(os.path.join(sets, "train.txt"))
        val_path = os.path.join(sets, "val.txt")
        val_ids = read_split(val_path) if os.path.exists(val_path) else []

    if args.dry_run:
        # the layout audit alone, before a long run
        import json

        from tpu_unet_torch.data.datasets import validate_layout
        from tpu_unet_torch.train.fit import DATASETS

        root = cfg.dataset_path if os.path.isabs(cfg.dataset_path) \
            else os.path.join(args.data_root, cfg.dataset_path)
        report = validate_layout(DATASETS[cfg.dataset], root, train_ids, val_ids,
                                 cfg.num_classes)
        print(json.dumps(report, indent=2))
        for w in report["warnings"]:
            print(f"WARNING: {w}")
        print("dry-run OK — dataset layout is usable; re-run without "
              "--dry-run to train")
        return
    wandb_logger = None
    if args.wandb:
        from tpu_unet_torch.train.wandb_logging import WandbLogger

        wandb_logger = WandbLogger(project=args.wandb_project,
                                   config=dataclasses.asdict(cfg))
    # evaluation during training is on by default, as the reference's
    fit(cfg, train_ids, val_ids, base_dir=args.data_root,
        device="cpu" if args.cpu else "cuda", wandb_logger=wandb_logger,
        auto_eval_callback=not args.no_eval)


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


def cmd_fold(args):
    """The RepVGG re-parameterisation, ``switch_to_deploy``'s counterpart
    (reference: RepVGG_Unet.py:203-207): a training checkpoint of the port
    (a state dict or a full state) in, the deploy form's state dict out,
    checked by loading it strictly into the ``deploy=True`` model."""
    import torch

    from tpu_unet_torch.infer.convert import read_state_dict
    from tpu_unet_torch.models.registry import build_model
    from tpu_unet_torch.models.repvgg import fold_repvgg

    folded = fold_repvgg(read_state_dict(args.model_path))
    classes = folded["final.weight"].shape[0]
    build_model(args.model, classes, deploy=True).load_state_dict(folded, strict=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(folded, args.out)
    print(f"folded {args.model_path} -> {args.out} ({args.model}, {classes} classes, "
          "deploy form: Unet(model_path=...) builds it)")


def cmd_summary(args):
    from tpu_unet_torch.tools.summary import summarize

    summarize(args.model, (args.size, args.size), args.num_classes or 21)


def cmd_export(args):
    from tpu_unet_torch.configs.infer_presets import build_wrapper

    build_wrapper(args.preset, **_wrapper_overrides(args)).convert_to_export(args.out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu_unet_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train")
    p.add_argument("--preset", required=True)
    p.add_argument("--data-root", default=".")
    p.add_argument("--data-path", default="")
    p.add_argument("--train-split", default="")
    p.add_argument("--val-split", default="")
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--eval-period", type=int,
                   help="epochs between validation mIoU evaluations")
    p.add_argument("--no-eval", action="store_true",
                   help="no mIoU evaluation during training")
    p.add_argument("--wandb", action="store_true",
                   help="log to wandb (raises where wandb does not import)")
    p.add_argument("--wandb-project", default="tpu-unet")
    p.add_argument("--save-dir", default="")
    p.add_argument("--no-pretrained", action="store_true",
                   help="train the backbone from random init even when the "
                        "preset asks for ImageNet weights")
    p.add_argument("--dry-run", action="store_true",
                   help="validate the dataset layout and splits, then exit")
    _add_common(p)
    p.set_defaults(fn=cmd_train)

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

    p = sub.add_parser("fold")
    p.add_argument("--model", default="repvgg_segnet")
    p.add_argument("--model-path", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_fold)

    p = sub.add_parser("summary")
    p.add_argument("--model", required=True)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--num-classes", type=int)
    p.add_argument("--cpu", action="store_true",
                   help="accepted for the common flags; the count runs on the CPU anyway")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("export")
    p.add_argument("--preset", required=True)
    p.add_argument("--out", required=True)
    _add_common(p)
    p.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
