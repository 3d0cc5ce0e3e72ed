"""Tracing / profiling utilities.

Counterpart of the JAX package's ``utils/profiling.py`` over PyTorch.
TaichiSLAM's observability is print-based per-stage wall-clock timing (the
node's pcl2npy/t_recast/t_export/t_mesh/t_pubros line). This module keeps
that print contract and adds:

- ``StageTimer``: named stage timing with EMA smoothing and the one-line
  per-frame report;
- ``trace(name)``: ``torch.profiler.record_function`` around a host stage
  (it shows in a ``torch.profiler`` capture);
- ``device_trace(log_dir)``: a ``torch.profiler.profile`` over the CPU and,
  when a card is present, CUDA, written as the Chrome trace
  ``<log_dir>/trace.json`` (``jax.profiler`` writes under its ``log_dir``).

Timings of device work are only meaningful when the card has finished it:
``StageTimer.stop(..., sync=t)`` synchronises the CUDA device of tensor
``t`` (nothing for a CPU tensor).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


class StageTimer:
    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema: Dict[str, float] = {}
        self.last: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def start(self, name: str):
        self._t0[name] = time.perf_counter()
        return self

    def stop(self, name: str, sync=None) -> float:
        """Stop a stage; ``sync`` (a tensor) first waits for the CUDA device
        it lives on, so the measurement includes device execution."""
        if sync is not None and sync.device.type == "cuda":
            import torch
            torch.cuda.synchronize(sync.device)
        ms = (time.perf_counter() - self._t0.pop(name)) * 1000.0
        self.last[name] = ms
        self.ema[name] = ms if name not in self.ema else \
            (1 - self.alpha) * self.ema[name] + self.alpha * ms
        return ms

    @contextlib.contextmanager
    def stage(self, name: str, sync_fn=None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, sync=sync_fn() if sync_fn else None)

    def report(self, prefix: str = "[TaichiSLAM]") -> str:
        """The node's per-frame timing line format."""
        parts = " ".join(f"{k} {v:.1f}ms" for k, v in self.last.items())
        return f"{prefix} Time: {parts}"


@contextlib.contextmanager
def trace(name: str):
    """torch.profiler annotation around a host-side stage."""
    import torch
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the CPU and the CUDA card (when present) and write a Chrome
    trace to ``<log_dir>/trace.json``, creating ``log_dir`` if missing
    (open it in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
