"""Shared settings of the port's CPU test files.

Each port test file imports ``one_torch_thread`` (an autouse fixture, so the
import is all it takes); ``jax_unimportable`` runs an entry point of the port
with JAX out of reach. A file whose tests write checkpoints also imports
``tmp_path``, which deletes each test's directory at its teardown."""

import contextlib
import importlib.abc
import shutil
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one intra-op thread for the module, the count
    restored after it. The port's CPU tests run many small tensor ops beside
    the suite's other parallel workers: intra-op threads that wait on one
    another for every op cost more than the ops and take the cores the other
    workers need (a case of the split-precision tests ran 0.05 s alone and
    5-9 s beside five busy workers; the port's test files took half the
    worker time on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at the test's teardown. pytest keeps
    every directory of a session (and of the two sessions before it): one
    checkpoint of the tiny model is ~165 MB, so the port's files left GBs
    under the suite's temporary root."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@contextlib.contextmanager
def deleted_after(path):
    """Yield ``path``; delete it after (a module fixture's directory)."""
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


_JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "generative_detection_tpu")


def _is_jax(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in _JAX_MODULES)


class _RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _is_jax(name):
            raise ImportError(f"{name} cannot be imported here")
        return None


@contextlib.contextmanager
def jax_unimportable():
    """Inside, jax, flax, optax, orbax and the JAX package cannot be
    imported: their modules leave ``sys.modules`` (restored after) and an
    import finder refuses them. Cheaper than a fresh process for running a
    port entry point without JAX."""
    saved = {name: sys.modules.pop(name) for name in list(sys.modules) if _is_jax(name)}
    finder = _RefuseJax()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)
