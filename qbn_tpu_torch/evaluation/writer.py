"""Scalar metric writer (port of qbn_tpu/evaluation/writer.py): one JSON
object a line, {"tag", "value", "step", "wall_time"}, appended to
<log_dir>/scalars.jsonl and flushed at each write, the schema that
qbn_tpu's tools/scalars_to_tb.py turns into TensorBoard event files."""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({
            "tag": tag, "value": float(value), "step": int(step),
            "wall_time": time.time()}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
