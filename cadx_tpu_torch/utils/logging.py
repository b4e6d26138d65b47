"""Logging utilities: the reference's stdout tee, made explicit.

A copy of `cadx_tpu/utils/logging.py`, which imports no JAX.

The reference hijacks sys.stdout at import time to tee every print into
Training_And_Validation.txt (Classes/CNNModel.py:10-28 — an import-time
side effect that also broke module reuse). Same capability here, but
opt-in and scoped.
"""

from __future__ import annotations

import contextlib
import sys
from typing import IO


class Logger:
    """Tee writer: forwards to a terminal stream and a file (reference
    Logger, Classes/CNNModel.py:12-28)."""

    def __init__(self, terminal: IO, file: IO):
        self.terminal = terminal
        self.file = file

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.file.write(message)
        self.file.flush()

    def flush(self) -> None:
        self.terminal.flush()
        self.file.flush()

    def __getattr__(self, name):
        # delegate everything else (isatty, encoding, buffer, fileno, ...)
        # so libraries probing sys.stdout keep working under the tee
        return getattr(self.terminal, name)


@contextlib.contextmanager
def tee_stdout(path: str = "Training_And_Validation.txt", mode: str = "w"):
    """Scoped stdout tee: everything printed inside also lands in `path`."""
    with open(path, mode) as f:
        logger = Logger(sys.stdout, f)
        old = sys.stdout
        sys.stdout = logger
        try:
            yield logger
        finally:
            sys.stdout = old
