"""JSONL metrics logging (counterpart of `blink.obs.log.JsonlLogger`;
tensorboard waits for the tooling slice, ROADMAP.md queue 1)."""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Any


class JsonlLogger:
    """Append one JSON object per event to a file, or to stderr if path=''
    (stdout stays free for a command's own result line)."""

    def __init__(self, path: str = "") -> None:
        self._fh: IO[str] | None = open(path, "a") if path else None

    def log(self, **fields: Any) -> None:
        fields.setdefault("ts", time.time())
        line = json.dumps(fields, default=float)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
