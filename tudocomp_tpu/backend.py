"""Backend dispatch: the one place that names the platform and picks
each device kernel.

The program runs on an NVIDIA GPU (JAX platform ``gpu``). The host CPU
(``cpu``) runs the same programs through their plain XLA formulations;
the tests run there. Any other platform is refused instead of being
served by a silent fallback.

A Pallas kernel runs through the Pallas interpreter only when a caller
passes ``interpret=True`` explicitly (the CPU tests do). It is never
inferred from the platform.
"""

from __future__ import annotations

PLATFORMS = ("gpu", "cpu")


def platform(name: str | None = None) -> str:
    """The JAX platform the program runs on (``name`` overrides the
    default backend, for tests); raises on an unsupported one."""
    if name is None:
        import jax

        name = jax.default_backend()
    if name not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: tudocomp runs on "
            f"{' or '.join(PLATFORMS)}"
        )
    return name


def tbc2_decoder(name: str | None = None, *, interpret: bool = False) -> str:
    """TBC2 device decoder: ``"pallas"`` (the Triton-route kernel of
    ``ops/hufdec_pallas.py``) on the GPU, ``"scan"`` (the plain XLA
    ``lax.scan`` of ``ops/hufdec_jax.py``) on the CPU. ``interpret``
    runs the Pallas kernel through the interpreter on any platform."""
    if interpret:
        return "pallas"
    return "pallas" if platform(name) == "gpu" else "scan"


def decode_on_device(name: str | None = None) -> bool:
    """Whether ``tbc2(dec=auto)`` decodes on the device: yes on the GPU;
    on the CPU the native host decoder is the faster spec path."""
    return platform(name) == "gpu"
