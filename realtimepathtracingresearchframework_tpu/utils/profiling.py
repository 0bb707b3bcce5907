"""CPU + device profiling scopes.

Equivalent of:
- RAII ``ProfilingScope`` with static per-site records and hierarchical dump
  (``util/profiling.h:8-68``).
- GPU timestamp markers (``vulkan/profiling/profiling_scopes.h:20-198``):
  the marker taxonomy is kept; device timing is measured by bracketing
  dispatches with ``block_until_ready`` (accurate enough per-stage because
  JAX dispatch is async and the bracket synchronizes the stream, like a
  timestamp pair at queue granularity).
"""

from __future__ import annotations

import enum
import time
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from realtimepathtracingresearchframework_tpu.utils.online_stats import OnlineStats


class ProfilingMarker(enum.Enum):
    """Per-frame device timing markers.

    Mirrors the taxonomy of ``vulkan/profiling/profiling_scopes.h:20-125``.
    """

    BUILD_BLAS = "BuildBLAS"
    UPDATE_BLAS = "UpdateBLAS"
    BUILD_TLAS = "BuildTLAS"
    UPDATE_TLAS = "UpdateTLAS"
    RENDERING = "Rendering"
    PROCESSING = "Processing"
    TAA = "TAA"
    DOF = "DoF"
    RESTIR = "ReStir"
    DENOISE = "Denoise"
    READBACK = "Readback"


@dataclass
class _ScopeRecord:
    name: str
    level: int
    total_s: float = 0.0
    count: int = 0


class _ProfilerState(threading.local):
    def __init__(self):
        self.level = 0
        self.records: Dict[str, _ScopeRecord] = {}
        self.order: List[str] = []


_state = _ProfilerState()


class ProfilingScope:
    """Hierarchical CPU profiling scope (util/profiling.h:62).

    Usable as a context manager::

        with ProfilingScope("load scene"):
            ...
    """

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        _state.level += 1
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _state.level -= 1
        rec = _state.records.get(self.name)
        if rec is None:
            rec = _ScopeRecord(self.name, _state.level)
            _state.records[self.name] = rec
            _state.order.append(self.name)
        rec.total_s += dt
        rec.count += 1
        return False


def log_profiling_times(printer=print) -> None:
    """Dump the hierarchical scope log (util/profiling.cpp equivalent)."""
    for name in _state.order:
        rec = _state.records[name]
        printer(
            "%s%-40s %9.3f ms  (x%d)"
            % ("  " * rec.level, rec.name, rec.total_s * 1e3, rec.count)
        )


def reset_profiling() -> None:
    _state.records.clear()
    _state.order.clear()


class DeviceTimers:
    """Per-frame device marker timings with a sliding stats window.

    Equivalent of the GPU timestamp query pools + the 32-frame stabilized
    window of ``ProcessProfilingToolsVulkan``
    (vulkan/processing/process_profiling_tools.h:26-43).
    """

    WINDOW = 32

    def __init__(self):
        self._frame: Dict[str, float] = {}
        self._history: Dict[str, List[float]] = {}
        self.stats: Dict[str, OnlineStats] = {}

    @contextmanager
    def time(self, marker: ProfilingMarker, result_to_block=None):
        """Bracket a device dispatch; if ``result_to_block`` thunk is given it
        is called and its result blocked on before stopping the clock."""
        t0 = time.perf_counter()
        out = {}
        yield out
        val = out.get("result", result_to_block)
        if val is not None:
            try:
                import jax

                jax.block_until_ready(val)
            except Exception:
                pass
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.add(marker, dt_ms)

    def add(self, marker: ProfilingMarker, ms: float) -> None:
        name = marker.value
        self._frame[name] = self._frame.get(name, 0.0) + ms

    def end_frame(self) -> Dict[str, float]:
        """Roll the per-frame timings into the sliding window; returns them."""
        frame = dict(self._frame)
        for name, ms in frame.items():
            hist = self._history.setdefault(name, [])
            hist.append(ms)
            if len(hist) > self.WINDOW:
                hist.pop(0)
            st = self.stats.setdefault(name, OnlineStats())
            st.add(ms)
        self._frame.clear()
        return frame

    def window_stats(self, marker: ProfilingMarker):
        """(avg, mn, mx, stddev) over the sliding window for a marker."""
        hist = self._history.get(marker.value)
        if not hist:
            return (0.0, 0.0, 0.0, 0.0)
        st = OnlineStats()
        for v in hist:
            st.add(v)
        return (st.mean, st.minimum, st.maximum, st.stddev)
