"""Checkpoints and resume on ``torch.save``/``torch.load``
(``train/checkpoint.py`` of the JAX package, without orbax).

Directory layout under ``ckptdir``, as the JAX package's:
- ``best/<step>/``: the top-k steps by the monitored metric (``mode`` min or
  max; the latest one when there is no monitor);
- ``last/<step>/``: the latest step only (``-r logdir`` resumes from it);
- ``trainstep_checkpoints/<step>/``: the every-N-steps stream, all kept.

A step's directory holds ``net.pt`` (the network's state_dict), ``loss.pt``
(the loss modules: LPIPS, the discriminator, logvar), ``optim.pt`` (both
optimizers' Adam moments and step counts, their accumulation windows, and
the forward generator's state), ``meta.json`` (the step) and, under
``best/``, ``metrics.json``. A directory is written under a temporary name
and renamed when complete. ``restore`` puts all of it back, so a resumed run
continues bit for bit; ``restore_params`` reads the network (and the loss)
alone.

Saves copy the state to host memory on the caller's thread (new CPU tensors,
never the live parameters), so the next step may change the state at once.
With ``async_checkpointing`` the files are written on a background thread;
``wait_until_finished`` drains it (and raises what a write raised).

In a process group saves are collective: every rank calls them in the same
order (the optimizers' ``state_dict`` consolidates ZeRO-1 and FSDP moments
and the open window's gradients over the ranks, an FSDP-sharded module's
``state_dict`` its parameters), rank 0 alone writes, then the ranks meet at a
barrier (with ``async_checkpointing``, when the writes are drained). Every
rank restores from the same files, each optimizer and each FSDP unit taking
its partition, so a checkpoint restores at any world size, with FSDP, ZeRO-1
or neither.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import world

_FILES = ("net.pt", "loss.pt", "optim.pt")


def _host(obj):
    """A deep copy of ``obj`` with every tensor copied into new CPU memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def host_copy(state) -> Optional[Dict[str, object]]:
    """The train state as host tensors, by file; in a process group (where
    every rank must call it: the optimizers' state, and under FSDP the
    parameters, are gathered) on rank 0 only, None elsewhere."""
    optim = {"opt_ae": state.opt_ae.state_dict(), "opt_disc": state.opt_disc.state_dict()}
    net, loss = state.net.state_dict(), state.loss.state_dict()
    if world().rank != 0:
        return None
    return {
        "step": int(state.step),
        "net.pt": _host(net),
        "loss.pt": _host(loss),
        "optim.pt": {
            **_host(optim),
            "generator": None if state.generator is None else state.generator.get_state(),
        },
    }


def _barrier() -> None:
    if world().active:
        dist.barrier()


def _steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root) if d.isdigit())


class CheckpointManager:
    def __init__(
        self,
        ckptdir: str,
        monitor: Optional[str] = None,
        save_top_k: int = 3,
        save_last: bool = True,
        mode: str = "min",
        async_checkpointing: bool = False,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.ckptdir = os.path.abspath(ckptdir)
        self.monitor = monitor
        self.save_top_k = save_top_k if monitor else 1
        self.save_last_enabled = save_last
        self.mode = mode
        self.async_checkpointing = async_checkpointing
        self._writer: Optional[ThreadPoolExecutor] = None  # the async writes' thread
        self._pending: List[Future] = []
        self._host: Optional[tuple] = None  # (step, host copy) of the last save
        self._last_saved = self.latest_step()  # a second save of a step is skipped
        self.bytes_written = 0
        self.save_seconds = 0.0  # on the caller's thread
        self._lock = threading.Lock()
        # the best steps' scores, read back so a resumed run keeps its ranking
        self._scores: Dict[int, float] = {}
        for step in _steps(self._dir("best")):
            path = os.path.join(self._dir("best"), str(step), "metrics.json")
            if monitor and os.path.exists(path):
                with open(path) as f:
                    self._scores[step] = float(json.load(f)[monitor])
        os.makedirs(self.ckptdir, exist_ok=True)

    def _dir(self, sub: str) -> str:
        return os.path.join(self.ckptdir, sub)

    # -- writing -------------------------------------------------------------------

    def _payload(self, step: int, state):
        if self._host is None or self._host[0] != step:
            self._host = (step, host_copy(state))
        return self._host[1]

    def _write(self, sub: str, step: int, payload, metrics=None, keep=None) -> None:
        root = self._dir(sub)
        final = os.path.join(root, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        n = 0
        for name in _FILES:
            path = os.path.join(tmp, name)
            torch.save(payload[name], path)
            n += os.path.getsize(path)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step}, f)
        if metrics is not None:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in _steps(root):
            if keep is not None and old not in keep:
                shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)
        with self._lock:
            self.bytes_written += n

    def _submit(self, *args, **kw) -> None:
        if not self.async_checkpointing:
            self._write(*args, **kw)
            return
        if self._writer is None:  # one thread writes in order, until drained
            self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gdt-ckpt")
        self._pending.append(self._writer.submit(self._write, *args, **kw))

    def _save(self, sub: str, step: int, state, metrics=None, keep=None) -> None:
        t0 = time.perf_counter()
        payload = self._payload(step, state)
        if payload is not None:  # rank 0 writes
            self._submit(sub, step, payload, metrics, keep)
        if not self.async_checkpointing:
            _barrier()
        self.save_seconds += time.perf_counter() - t0

    def save_trainstep(self, step: int, state) -> None:
        """The every-N-steps stream into ``trainstep_checkpoints/``, all kept."""
        self._save("trainstep_checkpoints", step, state)

    def save_best(self, step: int, state, metrics: dict) -> None:
        """Keep ``step`` among the top-k by the monitor (or as the latest
        when there is no monitor)."""
        if self.monitor and self.monitor not in metrics:
            logging.warning("monitor %s missing from metrics; skip best-save", self.monitor)
            return
        clean = {k: float(v) for k, v in metrics.items()}
        if self.monitor:
            sign = 1.0 if self.mode == "min" else -1.0
            scores = {**self._scores, step: sign * clean[self.monitor]}
            keep = sorted(scores, key=lambda s: (scores[s], -s))[: self.save_top_k]
            if step not in keep:
                return
            self._scores = {s: scores[s] for s in keep}
        else:
            keep = [step]
        self._save("best", step, state, clean, keep=set(keep))

    def save_last(self, step: int, state) -> None:
        """``last/<step>``, unless that step is already there."""
        if self.save_last_enabled and step != self._last_saved:
            self._save("last", step, state, keep={step})
            self._last_saved = step

    def wait_until_finished(self) -> None:
        """Drain the async writes and stop their thread; raise the first
        error a write raised. In a process group with
        ``async_checkpointing`` the ranks then meet at a barrier (every rank
        must call it)."""
        pending, self._pending = self._pending, []
        try:
            for fut in pending:
                fut.result()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None
        if self.async_checkpointing:
            _barrier()

    # -- reading -------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = _steps(self._dir("last"))
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> str:
        self.wait_until_finished()  # in-flight saves land first
        sub = "last" if _steps(self._dir("last")) else "best"
        steps = _steps(self._dir(sub))
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoint under {self.ckptdir}")
            step = steps[-1]
        return os.path.join(self._dir(sub), str(step))

    def restore(self, state, step: Optional[int] = None):
        """Load the latest (or ``step``'s) checkpoint of ``last/`` (else
        ``best/``) into ``state`` in place and return it."""
        path = self._step_dir(step)

        def load(name):
            return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)

        with open(os.path.join(path, "meta.json")) as f:
            state.step = int(json.load(f)["step"])
        state.net.load_state_dict(load("net.pt"))
        state.loss.load_state_dict(load("loss.pt"))
        optim = load("optim.pt")
        state.opt_ae.load_state_dict(optim["opt_ae"])
        state.opt_disc.load_state_dict(optim["opt_disc"])
        if state.generator is not None and optim["generator"] is not None:
            state.generator.set_state(optim["generator"])
        self._host = None
        return state

    def restore_params(self, step: Optional[int] = None, loss: bool = False) -> dict:
        """``{"step", "net"}`` (and ``"loss"``) state_dicts on the CPU,
        without reading the optimizers' moments."""
        path = self._step_dir(step)
        with open(os.path.join(path, "meta.json")) as f:
            out = {"step": int(json.load(f)["step"])}
        names = ("net", "loss") if loss else ("net",)
        for name in names:
            out[name] = torch.load(os.path.join(path, f"{name}.pt"), map_location="cpu",
                                   weights_only=True)
        return out

    def close(self) -> None:
        self.wait_until_finished()


def save_on_signal(save_fn: Callable[[], None], signals=(signal.SIGUSR1, signal.SIGTERM)) -> dict:
    """Install checkpoint-on-signal handlers (the reference's SIGUSR1/SIGTERM
    hook). Returns the handlers they replace, for ``restore_signals``. Off
    the main thread, where Python cannot install handlers, it installs none."""
    if threading.current_thread() is not threading.main_thread():
        logging.warning("not the main thread: no checkpoint-on-signal handlers")
        return {}

    def handler(signum, frame):
        logging.info("Summoning checkpoint (signal %s).", signum)
        save_fn()

    return {s: signal.signal(s, handler) for s in signals}


def restore_signals(previous: dict) -> None:
    for s, h in previous.items():
        signal.signal(s, h)
