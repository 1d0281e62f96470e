"""One logging setup for the whole system: consistent names, no bare prints.

Every repro_torch module logs under the ``repro_torch.`` hierarchy
(``repro_torch.des_torch``, ...) so one `setup_logging()` call -- or
one dictConfig entry in an embedding service -- controls all of it.
`get_logger` is the single place modules obtain their logger, which keeps
the naming convention mechanical.
"""
from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "setup_logging"]

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    """Logger under the ``repro_torch.`` hierarchy (idempotent)."""
    if not name.startswith("repro_torch"):
        name = f"repro_torch.{name}"
    return logging.getLogger(name)


def setup_logging(level: int | str | None = None,
                  fmt: str = _FORMAT) -> logging.Logger:
    """Attach one stream handler to the ``repro_torch`` root logger.

    Idempotent: repeated calls only adjust the level.  The default level
    comes from ``$REPRO_LOG_LEVEL`` (WARNING when unset), so benchmarks
    and services flip verbosity without code changes.
    """
    if level is None:
        level = os.environ.get("REPRO_LOG_LEVEL", "WARNING")
    root = logging.getLogger("repro_torch")
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(fmt))
        root.addHandler(handler)
        root.propagate = False
    root.setLevel(level)
    return root
