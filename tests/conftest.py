"""Test configuration: run JAX on CPU with 8 virtual devices.

Multi-device sharding paths are validated on a virtual 8-device CPU
mesh; the GPU path runs through ``chip_smoke.py`` and ``bench.py`` on a
machine with the card.
"""

import os

# Unit tests always run on the host CPU with a virtual 8-device mesh,
# whatever accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# importing the package applies the compile-cache rule
# (utils/cachedir.py) before any test compiles
import tudocomp_tpu  # noqa: E402,F401

# Run the whole suite with the debug/paranoid invariant layer armed
# (reference IF_DEBUG/IF_PARANOID, def.hpp:27-60) so kernel changes are
# exercised against Kraft/permutation/LF checks.
os.environ.setdefault("TDC_PARANOID", "1")
