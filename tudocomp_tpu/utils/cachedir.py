"""Where the persistent XLA compilation cache lives.

The rule: when ``JAX_COMPILATION_CACHE_DIR`` is set, it is the only
cache directory (JAX reads it itself) and nothing here sets another.
Otherwise the cache is one fixed directory inside the checkout,
``<checkout>/.jax_cache/`` (git-ignored); a fixed path matters because
the path is part of what a cache hit needs.

CPU runs use a subdirectory keyed by a digest of this host's CPU
feature flags: XLA:CPU's cache stores AOT-compiled executables that
embed the compiling machine's feature set, and loading one on a host
with other features logs ``cpu_aot_loader`` mismatch errors and can
crash. Keying makes cross-machine reuse of CPU artifacts impossible
while keeping same-machine warm starts.
"""

from __future__ import annotations

import hashlib
import os
import platform

ENV = "JAX_COMPILATION_CACHE_DIR"

#: the checkout: the directory holding the ``tudocomp_tpu`` package
ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _cpu_feature_digest() -> str:
    """Stable 12-hex digest of this host's CPU feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    key = f"{platform.machine()}|{flags}"
    return hashlib.sha256(key.encode()).hexdigest()[:12]


def compile_cache_dir(environ=None) -> str:
    """The cache directory the rule above gives for ``environ``
    (default ``os.environ``); ``JAX_PLATFORMS`` naming ``cpu`` first
    selects the CPU-feature subdirectory."""
    env = os.environ if environ is None else environ
    if env.get(ENV):
        return env[ENV]
    base = os.path.join(ROOT, ".jax_cache")
    first = env.get("JAX_PLATFORMS", "").split(",")[0].strip().lower()
    if first == "cpu":
        return os.path.join(base, f"cpu-{_cpu_feature_digest()}")
    return base
