"""Tracing and timing (counterpart of regen3d_tpu/utils/profiling.py).

* ``timed`` spans go into a process-wide registry with a summary table,
  as in the JAX package;
* ``trace`` records a device trace with ``torch.profiler`` (CPU and, where
  there is a card, CUDA activity) and writes it into a directory as a
  Chrome trace (``trace.json``, viewable in Perfetto or chrome://tracing),
  where the JAX package writes ``jax.profiler``'s;
* ``device_timed`` spans time the same blocks on the card, between two
  CUDA events on the current stream (the host returns before the card
  finishes, so a host span of queued work measures the queueing);
  ``device_span_summary`` synchronises and reads them;
* ``device_memory_stats`` snapshots the card's allocator counters
  (``torch.cuda.memory_stats``, with ``max_memory_allocated``), or None
  without a card, where the JAX package reads the device's
  ``memory_stats()``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

log = logging.getLogger(__name__)

_SPANS: Dict[str, List[float]] = defaultdict(list)
_DEVICE_SPANS: Dict[str, List[Tuple["torch.cuda.Event", "torch.cuda.Event"]]] \
    = defaultdict(list)


@contextlib.contextmanager
def timed(name: str, log_it: bool = True) -> Iterator[None]:
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        _SPANS[name].append(dt)
        if log_it:
            log.info("[timing] %s: %.3fs", name, dt)


@contextlib.contextmanager
def device_timed(name: str, device) -> Iterator[None]:
    """Record CUDA events before and after the block on ``device``'s current
    stream (nothing where ``device`` is not a card)."""
    if torch.device(device).type != "cuda":
        yield
        return
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    try:
        yield
    finally:
        b.record()
        _DEVICE_SPANS[name].append((a, b))


def device_span_summary() -> List[Tuple[str, int, float, float]]:
    """(name, count, total_s, mean_s) of the device spans, sorted by total
    time; waits for the last recorded event of each."""
    rows = []
    for k, pairs in _DEVICE_SPANS.items():
        pairs[-1][1].synchronize()
        dts = [a.elapsed_time(b) / 1e3 for a, b in pairs]
        rows.append((k, len(dts), sum(dts), sum(dts) / len(dts)))
    return sorted(rows, key=lambda r: -r[2])


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """A torch.profiler trace of the block, written to
    ``trace_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def span_summary() -> List[Tuple[str, int, float, float]]:
    """(name, count, total_s, mean_s) sorted by total time."""
    rows = [(k, len(v), sum(v), sum(v) / len(v)) for k, v in _SPANS.items()]
    return sorted(rows, key=lambda r: -r[2])


def log_summary() -> None:
    for name, n, total, mean in span_summary():
        log.info("[timing] %-40s n=%-4d total=%8.2fs mean=%7.3fs",
                 name, n, total, mean)


def reset() -> None:
    _SPANS.clear()
    _DEVICE_SPANS.clear()


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator counters with ``max_memory_allocated`` (bytes)
    beside them, or None where there is no card."""
    if not torch.cuda.is_available():
        return None
    stats = dict(torch.cuda.memory_stats(device))
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return stats
