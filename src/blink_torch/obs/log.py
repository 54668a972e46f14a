"""Metrics logging: JSONL lines and tensorboard summaries (counterpart of
`blink.obs.log`)."""
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


class TensorboardLogger:
    """Tensorboard scalars and rendered images through
    torch.utils.tensorboard, or a no-op if logdir='' or no writer imports
    (the metrics are in the JSONL log all the same). The writer is imported
    here, not with the package: it loads TensorFlow where that is
    installed, which takes seconds."""

    def __init__(self, logdir: str = "") -> None:
        self._w = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._w = SummaryWriter(logdir)
            except Exception:  # no tensorboard: the metrics are in the JSONL log
                self._w = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def image(self, tag: str, hwc_image, step: int) -> None:
        """hwc_image: (H, W, 3) linear radiance, a tensor or an array."""
        if self._w is not None:
            import numpy as np

            if hasattr(hwc_image, "detach"):
                hwc_image = hwc_image.detach().cpu().numpy()
            img = np.clip(np.asarray(hwc_image), 0.0, 1.0)
            self._w.add_image(tag, img.transpose(2, 0, 1), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None

    def __enter__(self) -> "TensorboardLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
