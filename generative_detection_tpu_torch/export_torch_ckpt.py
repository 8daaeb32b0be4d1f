"""Export a run of the port as a reference ``.ckpt`` (``tools/export_torch_ckpt.py``
of the JAX package)::

    python -m generative_detection_tpu_torch.export_torch_ckpt \\
        -b configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml -r logs/<run> \\
        --out exported.ckpt

Reads the latest checkpoint of a run directory (or its ``checkpoints/``)
through ``train/checkpoint.py``: the network and the loss modules, without
the optimizers' moments. Exports the family the config's model names (a
``PoseAutoencoder``, or the plain ``Autoencoder`` as an ldm ``AutoencoderKL``).
Writes ``{'state_dict', 'global_step'}`` in the reference's layout (``utils/torch_compat.py``): the network, ``loss.logvar``
and the discriminator, LPIPS left out, the discriminator's BatchNorm buffers
as fresh defaults. The reference's ``init_from_ckpt`` and the port's
``ckpt_path`` both read it. A host job: it runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence


def get_parser():
    p = argparse.ArgumentParser(description="Export a port run as a reference .ckpt.")
    p.add_argument("-b", "--base", nargs="+", required=True, help="config YAML(s)")
    p.add_argument("-r", "--resume", required=True, help="run dir or checkpoints dir")
    p.add_argument("--out", required=True, help="output .ckpt path")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``; ``a.b=c`` dotlist overrides
    after the flags), export, and return ``{"step", "tensors", "out"}``."""
    from .config import instantiate_from_config, merge_configs
    from .train.checkpoint import CheckpointManager
    from .utils.torch_compat import EXPORTERS, save_torch_checkpoint

    logging.basicConfig(level=logging.INFO)
    opt, unknown = get_parser().parse_known_args(argv)
    config = merge_configs(opt.base, unknown)
    model = instantiate_from_config(config["model"])
    ckptdir = opt.resume
    if os.path.isdir(os.path.join(ckptdir, "checkpoints")):
        ckptdir = os.path.join(ckptdir, "checkpoints")
    restored = CheckpointManager(ckptdir, monitor=model.monitor).restore_params(loss=True)
    net = model.build_net()
    net.load_state_dict(restored["net"])
    loss = model.build_loss()
    loss.load_state_dict(restored["loss"])
    step = restored["step"]
    logging.info("Restored the network and loss at step %d from %s", step, ckptdir)
    sd = EXPORTERS[model.step_family](net, loss)
    save_torch_checkpoint(opt.out, sd, global_step=step)
    logging.info("Wrote %d tensors -> %s", len(sd), opt.out)
    return {"step": step, "tensors": len(sd), "out": opt.out}


if __name__ == "__main__":
    main()
