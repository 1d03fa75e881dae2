"""Stdlib logging setup of the port.

The port's copy of `findkmer_tpu/utils/logging.py`: one namespaced logger
("findkmer") with a stderr handler, whose level comes from
FINDKMER_LOGLEVEL (the CLI's --log sets it).
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "findkmer") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        _CONFIGURED = True
        root = logging.getLogger("findkmer")
        if not root.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter(
                    "%(asctime)s %(name)s %(levelname)s %(message)s"
                )
            )
            root.addHandler(h)
        root.setLevel(os.environ.get("FINDKMER_LOGLEVEL", "WARNING").upper())
    return logging.getLogger(name)
