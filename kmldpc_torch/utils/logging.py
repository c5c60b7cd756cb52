"""Tee logger mirroring the reference's logging behavior.

Reference: ``lab::logger`` (log.h:18-88, log.cc:78-113) — a singleton that
writes ``[YYYY-mm-dd HH:MM:SS][Level] message`` lines to
``logs/<timestamp>-kmldpc.logger`` and, per-message, optionally to stdout
(the ``both_to_stdout`` flag: per-block chatter goes to file only, summary
lines to both).  Copy of ``kmldpc_tpu/utils/logging.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import datetime
import os
from typing import TextIO


class SimLogger:
    """File + optional-stdout tee with the reference's line format."""

    def __init__(self, log_dir: str | None = "logs", stdout: bool = True) -> None:
        self._file: TextIO | None = None
        self._stdout = stdout
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            ts = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            self._path = os.path.join(log_dir, f"{ts}-kmldpc.logger")
            self._file = open(self._path, "w")  # noqa: SIM115 — lifetime = run
        else:
            self._path = ""

    @staticmethod
    def _stamp(level: str, message: str) -> str:
        now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        return f"[{now}][{level}] {message}"

    def _emit(self, line: str, to_stdout: bool) -> None:
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stdout and to_stdout:
            print(line, flush=True)

    def info(self, message: str, to_stdout: bool = True) -> None:
        """INFO(msg, flag) — flag=False keeps chatter out of the console."""
        self._emit(self._stamp("Info", message), to_stdout)

    def error(self, message: str, to_stdout: bool = True) -> None:
        self._emit(self._stamp("Error", message), to_stdout)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
