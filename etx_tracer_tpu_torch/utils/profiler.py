"""Render observability: wall-clock scopes, throughput counters, device
traces.

Counterpart of `etx_tracer_tpu/utils/profiler.py` (the reference's
profiler wrapper and Integrator::Status): `Status` keeps the Mrays/s
account, `Profiler` times named scopes on the host clock (end a scope
with `torch.cuda.synchronize()` for the device's time), and `device_trace`
records a `torch.profiler` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@dataclass
class Status:
  """Integrator::Status analogue."""
  completed_iterations: int = 0
  last_iteration_time: float = 0.0
  total_time: float = 0.0
  total_rays: float = 0.0

  @property
  def mrays_per_second(self) -> float:
    return self.total_rays / max(self.total_time, 1e-9) / 1e6


class Profiler:
  def __init__(self):
    self.scopes: dict[str, list[float]] = {}

  @contextlib.contextmanager
  def scope(self, name: str):
    t0 = time.perf_counter()
    try:
      yield
    finally:
      self.scopes.setdefault(name, []).append(time.perf_counter() - t0)

  def report(self) -> str:
    lines = []
    for name, times in sorted(self.scopes.items()):
      total = sum(times)
      lines.append(f"{name}: {total*1000:.1f}ms total, "
                   f"{total/len(times)*1000:.2f}ms avg over {len(times)} calls")
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
  """Record the host's operators, and the card's kernels where CUDA is
  available, while the scope is entered; on exit write the trace to
  `log_dir/trace-<pid>-<ns>.json` (Chrome trace format: chrome://tracing,
  Perfetto). Yields the profiler."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
