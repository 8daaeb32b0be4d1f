"""Joining a process group (``parallel/multihost.py`` of the JAX package).

The reference scales across processes with SLURM ``srun`` and Lightning DDP
(one process a GPU). The port does the same over ``torch.distributed``: one
process a card, launched by ``torchrun``, by ``srun`` or by ``train_cli``
itself (``spawn_ranks``), each reading its place from torch's launch
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; under ``srun`` ``SLURM_PROCID``, ``SLURM_STEP_NUM_TASKS``
and ``SLURM_LOCALID`` stand in for the first three).

Backends: NCCL for the card's tensors with gloo beside it for host tensors
(``cpu:gloo,cuda:nccl``) where CUDA is present, gloo alone on the CPU.
``GDT_DIST_BACKEND`` overrides the choice, for example ``gloo`` for two ranks
on one card, which NCCL refuses.

Unlike the JAX package's ``initialize``, which logs and goes on alone when
the cluster cannot be joined, ``initialize`` raises: a world that was asked
for and cannot be joined is an error, never a silent single process.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import subprocess
import sys
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import all_gather_cat, world

# An explicit coordinator address means "join"; a world size counts only
# when it implies more than one process.
_COORDINATOR_MARKERS = ("MASTER_ADDR",)
_WORLD_SIZE_MARKERS = ("WORLD_SIZE",)
TIMEOUT = datetime.timedelta(minutes=30)


def should_initialize() -> bool:
    """Whether to join a process group at startup. Behaviour matrix:

    - ``GDT_MULTIHOST=1`` -> always (manual override);
    - ``GDT_MULTIHOST=0`` -> never (manual opt-out);
    - otherwise -> iff the launch environment implies a multi-process
      world: a coordinator address (``MASTER_ADDR``), a ``WORLD_SIZE`` above
      one, or an srun-launched step of more than one task
      (``SLURM_STEP_NUM_TASKS``, not the allocation's ``SLURM_NTASKS``: a
      bare ``python`` inside ``salloc -n 4`` is one process).
    """
    override = os.environ.get("GDT_MULTIHOST")
    if override == "1":
        return True
    if override == "0":
        return False
    if any(os.environ.get(v) for v in _COORDINATOR_MARKERS):
        return True
    for v in _WORLD_SIZE_MARKERS + ("SLURM_STEP_NUM_TASKS",):
        try:
            if int(os.environ.get(v, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return None


def default_backend() -> str:
    return os.environ.get("GDT_DIST_BACKEND") or (
        "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo")


def local_device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the cards present)
    where CUDA is present, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = _env_int("LOCAL_RANK", "SLURM_LOCALID") or 0
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(backend: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, timeout: datetime.timedelta = TIMEOUT):
    """Join the default process group from the launch environment (or the
    arguments) and return ``world()``; a no-op when one exists. On a card
    the rank's device becomes the current one. Raises when the environment
    does not name a world or the group cannot be formed."""
    if dist.is_initialized():
        return world()
    rank = _env_int("RANK", "SLURM_PROCID") if rank is None else rank
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", "SLURM_STEP_NUM_TASKS")
    if rank is None or world_size is None or not os.environ.get("MASTER_ADDR") \
            or not os.environ.get("MASTER_PORT"):
        raise RuntimeError(
            "a process group was asked for, but the environment does not name it: set RANK "
            "(or SLURM_PROCID), WORLD_SIZE (or SLURM_STEP_NUM_TASKS), MASTER_ADDR and "
            "MASTER_PORT, as torchrun does")
    backend = backend or default_backend()
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world_size,
                            timeout=timeout)
    w = world()
    logging.info("torch.distributed: rank %d of %d over %s", w.rank, w.size, backend)
    return w


def maybe_initialize():
    """Join the process group when the launch environment says one exists
    (``should_initialize``); ``initialize`` raises if it cannot. Returns
    ``world()``."""
    if should_initialize():
        return initialize()
    return world()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    """Rank-0 I/O gating (Lightning's ``rank_zero_only``)."""
    return world().rank == 0


def global_batch_from_local(local_batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The global host batch from each rank's local shard: every array
    gathered from all ranks and concatenated in rank order (the inverse of
    ``mesh.shard_batch``)."""
    return {k: all_gather_cat(torch.from_numpy(np.ascontiguousarray(v))).numpy()
            for k, v in local_batch.items()}


def free_port() -> int:
    """A TCP port the OS reports free on localhost (from its ephemeral
    range)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, size: int, port: int, base: Optional[Mapping[str, str]] = None) -> dict:
    """The launch environment of rank ``rank`` of ``size`` on this host,
    torchrun's variables over ``base`` (default: this process's)."""
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(size),
               LOCAL_WORLD_SIZE=str(size), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               GDT_MULTIHOST="1")
    return env


def spawn_ranks(args: Sequence[str], size: int, timeout: Optional[float] = None,
                env: Optional[Mapping[str, str]] = None) -> None:
    """Run ``python *args`` as ``size`` ranks of one world on this host, on a
    free port, as Lightning's DDP launcher does. Waits for all of them; when
    one fails (or ``timeout`` seconds pass) the others are killed and it
    raises."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *args], env=rank_env(r, size, port, env))
             for r in range(size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {size} exited with {failed[0][1]}")
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{size} ranks still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
