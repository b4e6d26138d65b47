"""End-to-end training CLI: mapping CSV -> trained model + artifacts.

Port of `cadx_tpu/tools/train.py`, the reference's offline training
workflow (Classes/CNNModel.py:592-620 and the artifacts under
static/trained_model/) as one command, with the same flags, files and
JSON. It runs on the card; `--device cpu` runs it on the CPU.

    python3 -m cadx_tpu_torch.tools.train --csv mapping.csv --out-dir out/ \\
        --pipeline basic --epochs 20 --batch-size 32 --features encoder

Writes, in --out-dir:
- cnn_model_{basic|advanced}.npz       (reference npz schema, best weights)
- training_History_{name}.json         (per-epoch loss/val_acc)
- training_summary_{name}.json         (dataset/model/training/evaluation/
                                        label_encoder/Training Time blocks)
- train_state.pkl                      (full resume state)
or, with --kfolds >= 2, crossval_summary.json.

Features modes:
- raw:     resized grayscale images as (H, W, 1) inputs, unit-normalised;
- encoder: the deployment path, per image at its native shape: the
           cleaning chain and 512² resize (`clean_for_unet`), the resnet
           encoder's conv1, a bilinear resize to --feature-size.

--bf16-compute runs the conv stack in bfloat16 (`fit(compute_dtype=
torch.bfloat16)`; parameters and evaluation stay float32). Not ported yet,
and refused rather than run on one device: --data-parallel (ROADMAP Queue
1, the `parallel/` slice).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cadx_tpu_torch.device import resolve


def load_images(csv_path: str):
    """(images list, labels int array, encoder dict), unreadable files
    skipped."""
    from cadx_tpu_torch.data import dataset

    ds = dataset.load_mapping_csv(csv_path)
    if not ds.raw_images:
        raise SystemExit(f"no readable DICOMs in {csv_path}")
    return ds.raw_images, np.asarray(ds.raw_classes), ds.label_encoder


def featurize(stem, img: np.ndarray, feature_hw, device) -> np.ndarray:
    """One image at its native shape -> (fh, fw, 64) float32: the cleaned
    512² gray in [0, 1], the encoder's conv1, a bilinear resize."""
    from cadx_tpu_torch.models import unet
    from cadx_tpu_torch.ops.resize import resize_linear
    from cadx_tpu_torch.precision import full_fp32
    from cadx_tpu_torch.preprocess import cleaner

    x = torch.from_numpy(np.asarray(img, np.float32)).to(device)[None]
    with full_fp32(), torch.no_grad():
        clean01 = cleaner.clean_for_unet(x)
        feats = unet.encoder_first_features(stem, clean01[..., None])
        return resize_linear(feats, feature_hw)[0].cpu().numpy()


def build_features(images, mode: str, resize_hw, feature_hw, encoder=None, device=None):
    """The classifier's inputs, (N, H, W, C) float32. `encoder` is the
    resnet stem of the encoder mode (seed 0's when None); `device` is the
    card when None."""
    from cadx_tpu_torch.data.dataset import normalize_images, resize_images

    dev = resolve(device)
    if mode == "raw":
        x = resize_images(images, resize_hw, device=dev)
        return normalize_images(x, "unit")[..., None].astype(np.float32)

    from cadx_tpu_torch.models import unet

    stem = encoder if encoder is not None else unet.init_resnet_stem(
        torch.Generator().manual_seed(0))
    stem = stem.to(dev)
    return np.stack([featurize(stem, im, feature_hw, dev) for im in images])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="cadx_tpu_torch trainer")
    ap.add_argument("--csv", required=True, help="mapping CSV (dicom_file_path,pathology)")
    ap.add_argument("--out-dir", default="trained_model")
    ap.add_argument("--pipeline", choices=["basic", "advanced"], default="basic")
    ap.add_argument("--features", choices=["raw", "encoder"], default="raw")
    ap.add_argument("--resize", type=int, default=64, help="raw-mode image size")
    ap.add_argument("--feature-size", type=int, default=32, help="encoder-mode feature size")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--test-size", type=float, default=0.2)
    ap.add_argument("--conv-layers", default="8x3,16x3",
                    help="e.g. 128x3,64x3 (filters x ksize per block)")
    ap.add_argument("--hidden-units", default="128,64")
    ap.add_argument("--dropout", type=float, default=0.3)
    ap.add_argument("--kfolds", type=int, default=0, help="run k-fold CV instead of a split")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard batches over all devices (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--bf16-compute", action="store_true",
                    help="bf16 conv compute (params/eval stay f32; "
                         "tolerance-level parity)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.data_parallel:
        raise SystemExit("--data-parallel is not ported to cadx_tpu_torch yet "
                         "(ROADMAP Queue 1 item 4)")

    from cadx_tpu_torch.data.dataset import split_train_test
    from cadx_tpu_torch.models import cnn
    from cadx_tpu_torch.train import crossval, step, summary

    dev = resolve(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    images, labels, encoder = load_images(args.csv)
    X = build_features(images, args.features, (args.resize, args.resize),
                       (args.feature_size, args.feature_size), device=dev)
    n_classes = int(labels.max()) + 1

    conv_layers = tuple(
        tuple(int(v) for v in part.split("x")) for part in args.conv_layers.split(","))
    hidden_units = tuple(int(v) for v in args.hidden_units.split(","))
    config = cnn.CNNConfig(
        input_shape=X.shape[1:], num_classes=n_classes,
        conv_layers=conv_layers, hidden_units=hidden_units,
        dropout_rate=args.dropout,
    )
    optimizer = "sgd" if args.pipeline == "basic" else "adam"
    lr = args.lr if args.lr is not None else (0.01 if optimizer == "sgd" else 1e-3)
    cdt = torch.bfloat16 if args.bf16_compute else None

    if args.kfolds >= 2:
        res = crossval.cross_validate(
            config, X, labels, n_splits=args.kfolds, epochs=args.epochs,
            lr=lr, batch_size=args.batch_size, optimizer=optimizer,
            log_fn=print, compute_dtype=cdt, device=dev)
        agg = res.aggregate_metrics()
        print(f"[CV] mean acc {agg['mean_accuracy']:.4f} "
              f"± {agg['std_accuracy']:.4f}")
        with open(os.path.join(args.out_dir, "crossval_summary.json"), "w") as f:
            json.dump(agg, f, indent=2)
        return agg

    Xtr, Xte, ytr, yte = split_train_test(X, labels, args.test_size, seed=args.seed)
    model = cnn.init_params(torch.Generator().manual_seed(args.seed), config)
    name = args.pipeline
    npz_path = os.path.join(args.out_dir, f"cnn_model_{name}.npz")
    res = step.fit(
        model, Xtr, np.eye(n_classes)[ytr], Xte, yte,
        epochs=args.epochs, lr=lr, batch_size=args.batch_size,
        optimizer=optimizer, seed=args.seed, log_fn=print,
        checkpoint_path=npz_path,
        state_path=os.path.join(args.out_dir, "train_state.pkl"),
        resume=args.resume, compute_dtype=cdt, device=dev,
    )

    y_pred = step.predict_classes(res.model, Xte)
    s = summary.build_summary(
        config=config, num_samples=len(X), train_split=len(Xtr),
        test_split=len(Xte), epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=lr, device=dev.type,
        best_val_acc=res.best_val_acc, y_true=yte, y_pred=y_pred,
        label_encoder=encoder, train_seconds=res.train_seconds,
    )
    summary.write_summary(s, os.path.join(args.out_dir, f"training_summary_{name}.json"))
    summary.write_history(res.history,
                          os.path.join(args.out_dir, f"training_History_{name}.json"))
    print(f"[DONE] best_val_acc={res.best_val_acc:.4f} "
          f"test_acc={s['evaluation']['test_accuracy']:.4f} "
          f"time={s['Training Time']}")
    return s


if __name__ == "__main__":
    main()
