"""Per-class box-height ranges (the root ``compute_hmin_hmax.py`` of the JAX
package, with its flag and pickles)::

    python -m generative_detection_tpu_torch.compute_hmin_hmax \\
        [--stats_dir dataset_stats/combined]

hmin, hmax = mean -/+ 2 std of the box height ``h`` per class, from
``raw_moments.pkl`` (else from the (mean, logvar) pairs of ``all.pkl``),
written to ``hmin.pkl`` and ``hmax.pkl`` in the same directory: the nuScenes
reader's z normalisation reads them (``h_minmax_dir``).
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
from typing import Optional, Sequence, Tuple


def main(argv: Optional[Sequence[str]] = None) -> Tuple[dict, dict]:
    """Parse ``argv`` (default ``sys.argv[1:]``), write the pickles, return
    (hmin, hmax)."""
    p = argparse.ArgumentParser(description="Per-class box-height ranges from dataset stats.")
    p.add_argument("--stats_dir", type=str, default="dataset_stats/combined")
    opt = p.parse_args(argv)

    raw_path = os.path.join(opt.stats_dir, "raw_moments.pkl")
    hmin, hmax = {}, {}
    if os.path.exists(raw_path):
        with open(raw_path, "rb") as f:
            rows = {label: (row["h"]["mean"], row["h"]["std"])
                    for label, row in pickle.load(f).items()}
    else:
        with open(os.path.join(opt.stats_dir, "all.pkl"), "rb") as f:
            rows = {label: (row["h"][0], math.exp(0.5 * row["h"][1]))
                    for label, row in pickle.load(f).items()}
    for label, (mean, std) in rows.items():
        hmin[label] = mean - 2 * std
        hmax[label] = mean + 2 * std

    with open(os.path.join(opt.stats_dir, "hmin.pkl"), "wb") as f:
        pickle.dump(hmin, f)
    with open(os.path.join(opt.stats_dir, "hmax.pkl"), "wb") as f:
        pickle.dump(hmax, f)
    print("hmin:", hmin)
    print("hmax:", hmax)
    return hmin, hmax


if __name__ == "__main__":
    main()
