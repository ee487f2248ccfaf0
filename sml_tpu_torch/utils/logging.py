"""Structured metrics logging: one JSON line per record, with a timestamp
(counterpart of ``sml_tpu/utils/logging.py``; the same record layout)."""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO


class MetricsLogger:
    def __init__(self, path: Optional[str], echo: bool = False):
        self._fh: Optional[TextIO] = open(path, "a") if path else None
        self.echo = echo

    def log(self, **record) -> None:
        record.setdefault("ts", time.time())
        line = json.dumps(record, default=float)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
