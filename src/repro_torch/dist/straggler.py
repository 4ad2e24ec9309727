"""Straggler detection (``repro.dist.straggler``): an EWMA step-time
spike monitor and host heartbeats. Pure host code, the reference's, with
no JAX in it.

A synchronous job runs at the speed of its slowest participant. The
monitor tracks an EWMA of *healthy* step times (spikes are excluded from
the statistics, so a straggler cannot poison its own detection
threshold) and escalates WARN -> EVICT after ``consecutive_limit``
consecutive slow steps. The trainer reacts to EVICT by checkpointing
(``launch/train.py``). Warmup steps always return OK, so the first steps'
kernel builds cannot trip it. ``HeartbeatRegistry`` reports hosts whose
heartbeats stopped; it only reports, and fences nothing.
"""

from __future__ import annotations

import enum
import time
from typing import Callable


class Action(enum.Enum):
    OK = "ok"
    WARN = "warn"
    EVICT = "evict"


class StragglerMonitor:
    """Per-step wall-time monitor.

    warmup_steps      observations that only build statistics (compile
                      steps, cache warmup) and always return OK
    spike_factor      dt > spike_factor * mean counts as slow
    consecutive_limit slow streak length that triggers EVICT
    ewma_alpha        smoothing for the healthy-step mean
    on_warn/on_evict  callbacks ``(step, dt)``
    """

    def __init__(self, warmup_steps: int = 10, spike_factor: float = 2.0,
                 consecutive_limit: int = 3, ewma_alpha: float = 0.1,
                 on_warn: Callable[[int, float], None] | None = None,
                 on_evict: Callable[[int, float], None] | None = None):
        self.warmup_steps = warmup_steps
        self.spike_factor = spike_factor
        self.consecutive_limit = consecutive_limit
        self.ewma_alpha = ewma_alpha
        self.on_warn = on_warn
        self.on_evict = on_evict
        self.mean: float | None = None
        self.consecutive = 0
        self.count = 0
        self._t0: float | None = None

    def _update_mean(self, dt: float) -> None:
        if self.mean is None:
            self.mean = dt
        else:
            a = self.ewma_alpha
            self.mean = (1.0 - a) * self.mean + a * dt

    def observe(self, dt: float) -> Action:
        self.count += 1
        if self.count <= self.warmup_steps or self.mean is None:
            self._update_mean(dt)
            return Action.OK
        if dt > self.spike_factor * self.mean:
            # slow step: escalate, and do NOT fold into the EWMA
            self.consecutive += 1
            if self.consecutive >= self.consecutive_limit:
                self.consecutive = 0
                if self.on_evict is not None:
                    self.on_evict(self.count, dt)
                return Action.EVICT
            if self.on_warn is not None:
                self.on_warn(self.count, dt)
            return Action.WARN
        self.consecutive = 0
        self._update_mean(dt)
        return Action.OK

    # convenience wall-clock interface used by the trainer loop
    def step_start(self) -> None:
        self._t0 = time.monotonic()

    def step_end(self) -> Action:
        if self._t0 is None:
            return Action.OK
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(dt)


class HeartbeatRegistry:
    """Dead-host detection by missed heartbeats.

    Hosts call ``beat(host)`` each step; the coordinator calls ``tick()``
    once per step and gets back the hosts whose last beat is at least
    ``timeout_steps`` ticks old.
    """

    def __init__(self, num_hosts: int, timeout_steps: int = 3):
        self.num_hosts = num_hosts
        self.timeout_steps = timeout_steps
        self._tick = 0
        self._last_seen = {h: 0 for h in range(num_hosts)}

    def beat(self, host: int) -> None:
        self._last_seen[host] = self._tick

    def tick(self) -> list[int]:
        self._tick += 1
        return [h for h in range(self.num_hosts)
                if self._tick - self._last_seen[h] >= self.timeout_steps]
