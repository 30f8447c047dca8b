"""tudocomp-tpu: a lossless compression framework on JAX for the GPU.

Built from scratch in JAX/XLA/Pallas with the capabilities of the tudocomp
framework (see SURVEY.md / ARCHITECTURE.md). Compressors and coders are
composable, registered, named modules selectable at runtime from an algorithm
string such as ``lzss_lcp(coder=huff, threshold=5)``.
"""

__version__ = "0.1.0"


def _default_compile_cache() -> None:
    """Make the persistent XLA compile cache the default for every
    entry point (CLI, library, bench), at the directory
    ``utils/cachedir.py`` names. ``JAX_COMPILATION_CACHE_DIR``, when
    set, is left to JAX alone; opt out with TDC_NO_COMPILE_CACHE=1."""
    import os

    from tudocomp_tpu.utils.cachedir import ENV, compile_cache_dir

    if os.environ.get("TDC_NO_COMPILE_CACHE") or os.environ.get(ENV):
        return
    import jax

    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_default_compile_cache()

from tudocomp_tpu.ranges import (  # noqa: F401
    Range,
    BitRange,
    LiteralRange,
    LengthRange,
    MinDistributedRange,
    bit_r,
    literal_r,
    uliteral_r,
    len_r,
    size_r,
)
