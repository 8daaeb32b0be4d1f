#!/usr/bin/env python3
"""Host cost of a call of a PyTorch operator on the card, by registration
route, with a body that launches nothing: the port's ``gdt`` operators are
``torch.library.Library`` ones, and this measures what that choice costs
per kernel call against a plain Python call and ``@torch.library.custom_op``.

    python3 tools/op_dispatch_cost.py [--calls 2000] [--repeats 25]

Three routes call one Python function with the GroupNorm forward's signature
(``gdt::group_norm``'s schema) whose body is ``torch.empty_like(x)`` (an
allocation from the caching allocator, no kernel): the function itself,
the function as the CUDA implementation of an operator defined with
``torch.library.Library`` in the namespace ``gdt_probe``, and the function as
a ``@torch.library.custom_op`` there. Each repeat times ``--calls`` calls of
each route back to back on the host clock, the routes in turn; the median
over repeats of the µs a call, and the routes' differences to the Python
call, are printed under ``inference_mode`` (the detector's) and with
autograd on (the train step's), as one JSON line; the card's name and power
limit come last. The x is the detector's smallest GroupNorm site (batch 1,
16x16x512 bf16).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

SCHEMA = "(Tensor x, Tensor gamma, Tensor beta, int num_groups, float eps, str? act) -> Tensor"


def _routes():
    import torch

    def body(x, gamma, beta, num_groups, eps, act):
        return torch.empty_like(x)

    lib = torch.library.Library("gdt_probe", "DEF")
    lib.define("library_op" + SCHEMA)
    lib.impl("library_op", body, "CUDA")
    custom = torch.library.custom_op("gdt_probe::custom_op", mutates_args=(),
                                     device_types="cuda", schema=SCHEMA)(body)
    return lib, {"python_call": body, "library_op": torch.ops.gdt_probe.library_op,
                 "custom_op": custom}


def measure(calls: int, repeats: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    lib, routes = _routes()
    x = torch.randn(1, 16, 16, 512, device="cuda").bfloat16()
    gamma, beta = torch.ones(512, device="cuda"), torch.zeros(512, device="cuda")
    args = (x, gamma, beta, 32, 1e-6, "silu")
    out = {"calls": calls, "repeats": repeats}
    for mode, ctx in (("inference_mode", torch.inference_mode), ("autograd", torch.enable_grad)):
        lat = {k: [] for k in routes}
        with ctx():
            for fn in routes.values():  # warm up
                for _ in range(200):
                    fn(*args)
            for _ in range(repeats):
                for name, fn in routes.items():
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn(*args)
                    lat[name].append((time.perf_counter() - t0) / calls * 1e6)
        us = {k: statistics.median(v) for k, v in lat.items()}
        out[mode] = {"us_per_call": us,
                     "library_op_overhead_us": us["library_op"] - us["python_call"],
                     "custom_op_overhead_us": us["custom_op"] - us["python_call"],
                     "spread_us": {k: max(v) - min(v) for k, v in lat.items()}}
    del lib
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=2000)
    p.add_argument("--repeats", type=int, default=25)
    opt = p.parse_args(argv)
    print(json.dumps(measure(opt.calls, opt.repeats)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
