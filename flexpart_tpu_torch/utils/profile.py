"""Named-section timing for the simulation loop.

Port of ``flexpart_tpu/utils/profile.py``.  The reference instruments its
phases with mpif_mtime('sectionname') pairs (mpi_mod.f90:2396-2464) and
prints a per-section table at run end (FLEXPART_MPI.f90:465-480).  Here
each section optionally synchronises with its device at exit
(``torch.cuda.synchronize``) so the measured wall time includes the
asynchronously launched device work of that phase; without it the time
would land in whichever section happens to block first.

Zero overhead when disabled: sections only accumulate host wall time and
never force a device synchronise.  The two dictionaries are written under
a lock: the met reader thread adds to them while the step loop does.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import torch


class SectionTimers:
    def __init__(self, device_sync: bool = False,
                 device: torch.device | str = "cpu"):
        self.device_sync = device_sync
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._lock = threading.Lock()

    def _sync(self) -> None:
        if self.device_sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def section(self, name: str):
        """Time a phase; with ``device_sync`` on a CUDA device the timer
        waits for the device at exit so the phase's device time lands in
        this section."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float):
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def report(self, extra: dict | None = None) -> str:
        """Per-section table like the reference's end-of-run timing
        output (FLEXPART_MPI.f90:465-480)."""
        with self._lock:
            seconds, calls = dict(self.seconds), dict(self.calls)
        total = sum(seconds.values())
        lines = [f"{'section':<14} {'seconds':>10} {'calls':>8} {'%':>6}"]
        for name, s in sorted(seconds.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * s / total if total > 0 else 0.0
            lines.append(f"{name:<14} {s:>10.3f} {calls[name]:>8d}"
                         f" {pct:>6.1f}")
        lines.append(f"{'TOTAL':<14} {total:>10.3f}")
        for k, v in (extra or {}).items():
            lines.append(f"{k:<14} {v}")
        return "\n".join(lines)
