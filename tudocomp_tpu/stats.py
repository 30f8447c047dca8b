"""StatPhase: nested time/memory phase tracking with JSON export.

Re-design of the reference's observability layer
(``tudocomp_stat/StatPhase.hpp:24-336``, malloc override
``src/tudocomp_stat/malloc.cpp``): RAII-nested phases measuring wall time
and memory, arbitrary key-value stats, ``split()`` siblings, and a JSON
tree compatible in spirit with the reference's ``--stats`` output / the
D3 charter app.

Device adaptations:
- host memory is sampled via ``tracemalloc`` when enabled (the Python
  equivalent of the reference's malloc hook);
- device memory is sampled from ``jax.local_devices()[0].memory_stats()``
  when a backend is live — per-phase peaks of live device-memory bytes;
- phases also emit ``jax.profiler.TraceAnnotation`` ranges so phase names
  show up in Perfetto traces captured with the JAX profiler.
"""

from __future__ import annotations

import json
import time
import tracemalloc
from typing import Any, Dict, List, Optional

STATS_ENABLED = True


def _device_mem() -> int:
    try:
        import sys

        jax = sys.modules.get("jax")
        if jax is None:
            return 0
        # never *initialize* a backend just to read memory stats: backend
        # start-up (device enumeration, memory reservation) would land
        # inside whatever phase happened to run first
        from jax._src import xla_bridge

        if not xla_bridge._backends:
            return 0
        stats = jax.local_devices()[0].memory_stats()
        if stats:
            return int(stats.get("bytes_in_use", 0))
    except Exception:
        pass
    return 0


class StatPhase:
    """Nested phase timer. Use as a context manager::

        with StatPhase("compress") as root:
            with StatPhase("construct sa"):
                ...
            root.log_stat("factors", n)
        print(root.to_json_str())
    """

    _current: Optional["StatPhase"] = None

    def __init__(self, title: str, track_memory: bool = False):
        self.title = title
        self.children: List[StatPhase] = []
        self.stats: Dict[str, Any] = {}
        self.parent: Optional[StatPhase] = None
        self.track_memory = track_memory
        self.duration_ms = 0.0
        self.mem_peak = 0
        self.dev_mem_peak = 0
        self._t0 = 0.0
        self._trace = None

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "StatPhase":
        self.parent = StatPhase._current
        if self.parent is not None:
            self.parent.children.append(self)
            self.track_memory = self.track_memory or self.parent.track_memory
        StatPhase._current = self
        if self.track_memory and not tracemalloc.is_tracing():
            tracemalloc.start()
        if self.track_memory:
            self._mem0 = tracemalloc.get_traced_memory()[0]
        self._dev0 = _device_mem()
        try:
            import jax

            self._trace = jax.profiler.TraceAnnotation(self.title)
            self._trace.__enter__()
        except Exception:
            self._trace = None
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.duration_ms = (time.monotonic() - self._t0) * 1000.0
        if self._trace is not None:
            self._trace.__exit__(*exc)
        if self.track_memory:
            cur, peak = tracemalloc.get_traced_memory()
            self.mem_peak = max(self.mem_peak, peak - self._mem0)
        self.dev_mem_peak = max(self.dev_mem_peak, _device_mem() - self._dev0)
        StatPhase._current = self.parent
        # bubble peaks up like the reference (StatPhase.hpp:73-86)
        if self.parent is not None:
            self.parent.mem_peak = max(self.parent.mem_peak, self.mem_peak)
            self.parent.dev_mem_peak = max(
                self.parent.dev_mem_peak, self.dev_mem_peak
            )

    def split(self, title: str) -> "StatPhase":
        """End the current sub-phase context and open a sibling (reference
        ``StatPhase.hpp:264-288``). Use inside a ``with`` as a manual
        sequence of sibling phases."""
        child = StatPhase(title, self.track_memory)
        child.parent = self
        self.children.append(child)
        return child

    # -- stats ---------------------------------------------------------------

    def log_stat(self, key: str, value: Any) -> None:
        self.stats[key] = value

    @classmethod
    def current(cls) -> Optional["StatPhase"]:
        return cls._current

    @classmethod
    def wrap(cls, title: str, fn, *args, **kwargs):
        """Run ``fn`` inside a phase, return its result."""
        with cls(title):
            return fn(*args, **kwargs)

    @classmethod
    def log(cls, key: str, value: Any) -> None:
        """Log into the innermost active phase, if any."""
        if cls._current is not None:
            cls._current.log_stat(key, value)

    # -- export --------------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        """Reference-shaped phase tree (``StatPhase.hpp:311-321``)."""
        return {
            "title": self.title,
            "timeDelta": self.duration_ms,
            "memPeak": self.mem_peak,
            "devMemPeak": self.dev_mem_peak,
            "stats": [
                {"key": k, "value": v} for k, v in self.stats.items()
            ],
            "sub": [c.to_json() for c in self.children],
        }

    def to_json_str(self, indent: int = 2) -> str:
        return json.dumps(self.to_json(), indent=indent)


class StatPhaseDummy:
    """No-op stand-in (reference ``STATS_DISABLED`` path)."""

    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass

    def log_stat(self, *a):
        pass

    def split(self, title):
        return self
