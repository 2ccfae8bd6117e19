"""Observability, the port of ``enflow_tpu/utils/observe.py``.

- ``MetricsLogger`` appends structured rows to a CSV.
- ``profile_trace`` records a ``torch.profiler`` trace (host and, on the
  card, CUDA activity) into a directory as a Chrome/Perfetto JSON file;
  with no directory it does nothing.
- ``nan_guard`` is the counterpart of ``jax_debug_nans``, scoped to a
  block: autograd's anomaly mode checks the output of every backward node
  (the kernels' ``autograd.Function.backward`` included) for NaN, and the
  ``check`` it yields raises at a non-finite forward value handed to it
  (the driver hands it each step's loss). Both raise
  ``FloatingPointError``. The anomaly state is restored on exit.
- ``assert_all_finite`` checks a tree of tensors or arrays on the host.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time

import numpy as np
import torch


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


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``
    (``trace_<time>.json``, Chrome/Perfetto format; no other package
    needed). Does nothing when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
        ".json"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def assert_all_finite(tree, name="tree"):
    """Raise ``FloatingPointError`` naming the first leaf of ``tree``
    (nested dicts/lists of tensors or arrays) that holds a non-finite
    value. Reads every leaf on the host (a synchronization on the
    card)."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            bad = int((~torch.isfinite(leaf)).sum()) if \
                leaf.is_floating_point() else 0
        else:
            arr = np.asarray(leaf)
            bad = int(np.count_nonzero(~np.isfinite(arr))) if \
                np.issubdtype(arr.dtype, np.inexact) else 0
        if bad:
            raise FloatingPointError(
                f"non-finite values in {name}{path}: {bad} bad entries")


def _no_check(tree, name="tree"):
    return None


@contextlib.contextmanager
def nan_guard(enabled: bool = True):
    """Scoped NaN checks; yields ``check(tree, name)``. Enabled: autograd
    anomaly mode with NaN checks for the block (a backward node that
    returns NaN raises ``FloatingPointError`` naming the node), and
    ``check`` is :func:`assert_all_finite`. Disabled: nothing is checked
    and ``check`` does nothing. The previous anomaly state comes back on
    exit."""
    if not enabled:
        yield _no_check
        return
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield assert_all_finite
    except RuntimeError as e:
        if "returned nan values" in str(e):
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        torch.autograd.set_detect_anomaly(*prev)
