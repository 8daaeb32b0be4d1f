"""Small cross-cutting utilities (``utils/misc.py`` of the JAX package)."""

from __future__ import annotations

import json
import logging


class EasyDict(dict):
    """A dict whose keys read and write as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def log_opts(opt) -> None:
    """Log parsed command-line options as JSON."""
    try:
        payload = json.dumps(vars(opt), indent=2, default=str)
    except TypeError:
        payload = str(opt)
    logging.info("Options:\n%s", payload)
