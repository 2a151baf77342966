"""Straggler / hang mitigation for the training loop.

On a real multi-pod deployment every host runs this around its step
function; the controller aggregates.  Mechanisms:

* **EMA step-time outlier detection** — a step slower than
  ``threshold ×`` the EMA flags a straggler event (logged + counted;
  deployment hooks decide whether to evict/replace the host).
* **hang watchdog** — a monitor thread fires a callback if no step
  completes within ``hang_timeout`` seconds (e.g. a stuck collective),
  so the launcher can checkpoint-and-restart instead of burning the
  reservation.
* **preemption** — SIGTERM sets a flag the loop polls to trigger a final
  synchronous checkpoint before the machine disappears.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional


class StepWatchdog:
    def __init__(self, ema_alpha: float = 0.1, threshold: float = 2.5,
                 hang_timeout: float = 0.0,
                 on_hang: Optional[Callable[[], None]] = None):
        self.ema_alpha = ema_alpha
        self.threshold = threshold
        self.hang_timeout = hang_timeout
        self.on_hang = on_hang
        self.ema: Optional[float] = None
        self.straggler_events = 0
        self.steps = 0
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        if hang_timeout > 0:
            self._monitor = threading.Thread(target=self._watch, daemon=True)
            self._monitor.start()

    def record_step(self, seconds: float) -> bool:
        """Returns True if this step was a straggler."""
        self.steps += 1
        self._last_beat = time.monotonic()
        straggler = False
        if self.ema is not None and seconds > self.threshold * self.ema:
            self.straggler_events += 1
            straggler = True
        if self.ema is None:
            self.ema = seconds
        else:
            # Clamp outliers so one straggler doesn't poison the baseline.
            s = min(seconds, 4.0 * self.ema)
            self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * s
        return straggler

    def _watch(self):
        while not self._stop.wait(min(self.hang_timeout / 4, 5.0)):
            if time.monotonic() - self._last_beat > self.hang_timeout:
                if self.on_hang:
                    self.on_hang()
                self._last_beat = time.monotonic()

    def close(self):
        self._stop.set()


class PreemptionHandler:
    """SIGTERM/SIGINT → ``requested`` flag the train loop polls."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
