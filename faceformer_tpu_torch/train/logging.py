"""Metrics logging: JSONL scalars + optional TensorBoard events (a copy of
faceformer_tpu/train/logging.py).

The reference logs scalars + qualitative pred-vs-label text to TensorBoard
(reference: trainer.py:85-101, main.py:39). Here the source of truth is an
append-only metrics.jsonl (machine-readable, diffable); TensorBoard event
files are written too when a writer is importable.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:  # optional TensorBoard writer
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        record = {"step": step, "time": time.time()}
        for key, val in scalars.items():
            val = float(val)
            # json.dumps would emit bare NaN/Infinity — not valid JSON, and
            # one NaN-loss step (which the trainer logs even as it skips the
            # update) would break every strict JSONL consumer of this file
            record[prefix + key] = val if math.isfinite(val) else None
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            for key, val in scalars.items():
                self._tb.add_scalar(prefix + key, float(val), step)

    def log_text(self, tag: str, text: str, step: int) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, text, step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
