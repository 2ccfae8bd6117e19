"""Metrics logging, the port of ``MetricsLogger`` in
``enflow_tpu/utils/observe.py`` (the port keeps its own copy). The JAX
module's profiler hook and NaN guard are not ported (ROADMAP A5.6): the
driver raises on ``training.profile_dir`` and
``debug.nan_checks``."""

from __future__ import annotations

import csv
import os
import time


class MetricsLogger:
    """Append-only CSV metrics writer (one row per call; the columns are
    fixed at the first write, ``time`` first). Without a path it writes
    nothing."""

    def __init__(self, path=None):
        self.path = path
        self._writer = None
        self._fh = None
        self._fields = None

    def log(self, **metrics):
        if not self.path:
            return
        metrics = {"time": time.time(), **metrics}
        if self._writer is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", newline="")
            self._fields = list(metrics)
            self._writer = csv.DictWriter(self._fh, fieldnames=self._fields)
            if self._fh.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow({k: metrics.get(k, "") for k in self._fields})
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = self._writer = None
