"""Structured logging for rabitq_tpu_torch (the port's copy of
``rabitq_tpu/utils/logging.py``): one standard-library logger, silenced by
default and controlled with ``RABITQ_TPU_LOG`` (e.g. ``RABITQ_TPU_LOG=info``).
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER = logging.getLogger("rabitq_tpu_torch")
if not _LOGGER.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
    )
    _LOGGER.addHandler(_handler)
    _LOGGER.setLevel(
        getattr(logging, os.environ.get("RABITQ_TPU_LOG", "WARNING").upper(), logging.WARNING)
    )


def get_logger(name: str | None = None) -> logging.Logger:
    return _LOGGER if name is None else _LOGGER.getChild(name)

