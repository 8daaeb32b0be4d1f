"""OD-VAE evaluation entry point on the port (the root ``eval.py`` of the JAX
package, with its surface)::

    python -m generative_detection_tpu_torch.eval_cli \\
        -b configs/autoencoder/pose/synthetic_smoke.yaml [-r LOGDIR] \\
        [--split validation] [--limit 8] [-s 23] [--out metrics.json] [--device cpu]

Runs the network over a split at the fully trained phase gates (step 10**9,
phase 'full'), recovers camera-frame 3D boxes from the decoded poses, and
prints one JSON object: PSNR and KL of the reconstruction, the per-patch
detection metrics (``eval/metrics.py``) and the frame-level set-based ones
(``eval/detection.py``, keys ``set/...``). Batches of both image contracts
(float patches, and raw crops with ``device_preprocess: true``) go through
``prepare_batch``. Patches group into real frames by (sample_idx, cam_idx)
where the dataset emits them (the nuScenes reader does), else each patch is
its own pseudo-frame.

``-b`` base YAMLs and ``a.b=c`` dotlist overrides as in ``train_cli``; ``-r``
restores the network's parameters alone (a run directory or its
``checkpoints/``); without it the network is initialised from ``-s``.
``--device {cuda,cpu}`` (default cuda); ``lightning.trainer.accelerator:
cpu`` in the config selects the CPU too. The forward's random draws are made
on the CPU from ``-s``, so the card and the CPU see the same draws. One card,
no mesh; ``ckpt_path`` in the model config raises (reference checkpoints are
not read yet).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np

STEP = 10**9  # past every phase gate of the curriculum
NO_CLASS_ID = 10  # "background"


def get_parser():
    p = argparse.ArgumentParser(description="Evaluate an OD-VAE run on a split.")
    p.add_argument("-b", "--base", nargs="*", default=list())
    p.add_argument("-r", "--resume", type=str, default="", help="logdir or ckpt dir")
    p.add_argument("--split", type=str, default="validation")
    p.add_argument("--limit", type=int, default=None, help="max batches")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("--out", type=str, default=None, help="write metrics JSON here")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="evaluate on the card (default) or on the CPU")
    return p


def _sbox(frame, name, row, score=None) -> dict:
    d = {
        "frame": int(frame),
        "class_name": name,
        "center": np.asarray([row[0], row[2]], np.float32),  # BEV (x, z)
        "size": np.asarray(row[3:6], np.float32),
        "yaw": float(row[6]),
    }
    if score is not None:
        d["score"] = float(score)
    return d


def set_boxes(pred, cls, gt, gtcls, fg, score, frame, label_names) -> tuple:
    """The inputs of ``evaluate_detections``, as ``eval.py`` builds them:
    predictions of a real class and foreground ground truths as boxes by
    frame (a frame id < 0 becomes the patch's own pseudo-frame; a
    ground-truth box repeated within a frame counts once)."""
    preds, gts, seen = [], [], set()
    for f in range(pred.shape[0]):
        fid = int(frame[f]) if frame[f] >= 0 else (1 << 40) + f
        cid = int(cls[f])
        if 0 <= cid < len(label_names) and label_names[cid] != "background":
            preds.append(_sbox(fid, label_names[cid], pred[f], score[f]))
        if fg[f]:
            key = (fid, int(gtcls[f]), gt[f].tobytes())
            if key not in seen:
                seen.add(key)
                gts.append(_sbox(fid, label_names[int(gtcls[f])], gt[f]))
    return preds, gts


def _draws(model, rgb, generator) -> dict:
    """The forward's four draws for a batch, made on the CPU."""
    import torch

    b, h = rgb.shape[0], rgb.shape[1] // 2 ** (len(model.ddconfig["ch_mult"]) - 1)
    z = (b, h, h, model.embed_dim)
    out = {"posterior": torch.randn(z, generator=generator),
           "dropout": torch.rand(z, generator=generator),
           "noise": torch.randn(z, generator=generator),
           "bbox": torch.randn((b, 8), generator=generator)}
    return {k: v.to(rgb.device) for k, v in out.items()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``), evaluate, print the JSON and
    return the results."""
    import torch

    from .config import instantiate_from_config, merge_configs
    from .eval import (
        detection_metrics, evaluate_detections, frame_ids_from_batch, psnr, recover_boxes,
    )
    from .losses.contperceptual import LABEL_NAMES
    from .ops.precision import compute_precision
    from .train.checkpoint import CheckpointManager
    from .train.state import flax_like_net
    from .train.steps import _autocast

    logging.basicConfig(level=logging.INFO)
    opt, unknown = get_parser().parse_known_args(argv)
    config = merge_configs(opt.base, unknown)
    lightning_cfg = config.pop("lightning", {}) or {}
    cpu = (lightning_cfg.get("trainer", {}) or {}).get("accelerator") == "cpu"
    device = torch.device("cpu" if cpu else opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to evaluate on the CPU")
    model = instantiate_from_config(config["model"])
    data = instantiate_from_config(config["data"])
    data.setup()
    split = opt.split if opt.split in data.datasets else "validation"
    dataset = data.datasets[split]
    logging.info("Evaluating %s (%d items)", split, len(dataset))

    if opt.resume:
        ckptdir = opt.resume
        if os.path.isdir(os.path.join(ckptdir, "checkpoints")):
            ckptdir = os.path.join(ckptdir, "checkpoints")
        restored = CheckpointManager(ckptdir, monitor=model.monitor).restore_params()
        net = model.build_net()
        net.load_state_dict(restored["net"])
        net = net.to(device=device, memory_format=torch.channels_last)
        start_step = restored["step"]
        logging.info("Restored checkpoint params at step %d", start_step)
    else:
        net = flax_like_net(model, torch.Generator().manual_seed(opt.seed), device)
        start_step = 0
    net.eval()

    inner = getattr(dataset, "data", dataset)
    hmin_d = getattr(inner, "hmin_dict", {n: 0.5 for n in LABEL_NAMES})
    hmax_d = getattr(inner, "hmax_dict", {n: 4.0 for n in LABEL_NAMES})
    hmin_t = torch.tensor([hmin_d.get(n, 0.5) for n in LABEL_NAMES], device=device)
    hmax_t = torch.tensor([hmax_d.get(n, 4.0) for n in LABEL_NAMES], device=device)
    generator = torch.Generator().manual_seed(opt.seed)
    dtype = model.compute_dtype

    agg = {"psnr": [], "kl": []}
    cols = {k: [] for k in ("pred", "cls", "gt", "gtcls", "fg", "score", "frame")}
    loaders = {"validation": data.val_dataloader, "test": data.test_dataloader,
               "train": data.train_dataloader}
    try:
        for i, batch in enumerate(loaders.get(split, data.val_dataloader)()):
            if opt.limit is not None and i >= opt.limit:
                break
            prepared = model.prepare_batch(batch, device=device)
            rgb = prepared["rgb_gt"]
            with torch.no_grad(), compute_precision(dtype), _autocast(device, dtype):
                outs = net(rgb, STEP, phase="full", draws=_draws(model, rgb, generator))
            dec_obj = outs["dec_obj"].float()
            dec_pose = outs["dec_pose"].float()
            kl = outs["posterior_obj"].kl().float()
            rgb_np = rgb.cpu().numpy()
            agg["psnr"].append(psnr(rgb_np, dec_obj.cpu().numpy()))
            agg["kl"].append(float(np.mean(kl.cpu().numpy())))

            b = rgb_np.shape[0]
            cols["frame"].append(frame_ids_from_batch(batch, b))

            def on(key, *shape):
                return torch.as_tensor(np.asarray(batch[key], np.float32).reshape(b, *shape),
                                       device=device)

            if "cam2img" in batch:  # the camera of the info pkl
                K = on("cam2img", 3, 3)
                focal, pp = K[:, 0, 0], K[:, :2, 2]
            else:  # the synthetic datasets' fixed camera
                focal = torch.full((b,), 1266.0, device=device)
                pp = torch.tensor([[800.0, 450.0]], device=device).expand(b, 2)
            with compute_precision(torch.float32):
                rec = recover_boxes(dec_pose, focal_length=focal, principal_point=pp,
                                    patch_size=on("patch_size", -1)[:, 0],
                                    patch_center=on("patch_center_2d", 2),
                                    resampling_factor=on("resampling_factor"),
                                    hmin_table=hmin_t, hmax_table=hmax_t)
            cols["pred"].append(rec["boxes_3d"].cpu().numpy())
            cols["cls"].append(rec["class_id"].cpu().numpy())
            cols["gt"].append(np.asarray(batch["bbox_3d_gt"], np.float32).reshape(b, -1)[:, :7])
            gtcls = np.asarray(batch["original_class_id"])
            cols["gtcls"].append(gtcls)
            cols["fg"].append(gtcls != NO_CLASS_ID)
            # confidence: the sigmoid of the largest class logit (the focal head)
            logits = dec_pose[:, 8:].cpu().numpy()
            cols["score"].append(1.0 / (1.0 + np.exp(-np.max(logits, axis=-1))))
    finally:
        data.teardown()

    c = {k: np.concatenate(v) for k, v in cols.items()}
    results = {"split": split, "psnr": float(np.mean(agg["psnr"])),
               "kl": float(np.mean(agg["kl"])), "step": start_step}
    results.update(detection_metrics(c["pred"], c["cls"], c["gt"], c["gtcls"], c["fg"]))
    preds, gts = set_boxes(c["pred"], c["cls"], c["gt"], c["gtcls"], c["fg"], c["score"],
                           c["frame"], LABEL_NAMES)
    metrics = evaluate_detections(preds, gts, [n for n in LABEL_NAMES if n != "background"])
    results.update({f"set/{k}": v for k, v in metrics.items()})
    print(json.dumps(results, indent=2))
    if opt.out:
        with open(opt.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
