"""Backend dispatch (tudocomp_tpu/backend.py) and the compile-cache
directory rule (tudocomp_tpu/utils/cachedir.py)."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from tudocomp_tpu import backend
from tudocomp_tpu.utils import cachedir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_picks_the_xla_paths():
    assert backend.platform() == "cpu"  # the tests run on the CPU
    assert backend.tbc2_decoder("cpu") == "scan"
    assert backend.tbc2_decoder() == "scan"
    assert not backend.decode_on_device("cpu")


def test_gpu_picks_the_gpu_kernels():
    assert backend.tbc2_decoder("gpu") == "pallas"
    assert backend.decode_on_device("gpu")


@pytest.mark.parametrize("name", ["neuron", "METAL", "rocm", ""])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform(name)
    with pytest.raises(RuntimeError):
        backend.tbc2_decoder(name)
    with pytest.raises(RuntimeError):
        backend.decode_on_device(name)


def test_interpret_only_when_asked():
    # an explicit interpret=True runs the GPU kernel anywhere; nothing
    # defaults to it
    assert backend.tbc2_decoder("cpu", interpret=True) == "pallas"
    from tudocomp_tpu.models.blockcodec import BlockCodec
    from tudocomp_tpu.ops.hufdec_pallas import decode_segments_pallas

    sig = inspect.signature(decode_segments_pallas)
    assert sig.parameters["interpret"].default is False
    sig = inspect.signature(BlockCodec.decompress_device)
    assert sig.parameters["interpret"].default is False


def test_tbc2_dec_option_follows_the_dispatch():
    from tudocomp_tpu.compressors import REGISTRY

    assert REGISTRY.instantiate("tbc2").decoder() == "host"  # CPU auto
    assert REGISTRY.instantiate("tbc2(dec=host)").decoder() == "host"
    assert REGISTRY.instantiate("tbc2(dec=device)").decoder() == "scan"
    # headers written with the former kernel names still decode
    assert REGISTRY.instantiate("tbc2(dec=pallas)").decoder() == "scan"
    with pytest.raises(ValueError):
        REGISTRY.instantiate("tbc2(dec=gpu)").decoder()


def test_tbc2_dec_device_roundtrip():
    from tudocomp_tpu import cli

    data = b"tbc2 decoded on the device " * 200
    comp = cli.compress("tbc2(dec=device)", data)
    assert cli.decompress(comp) == data


def test_bwt_device_runs_the_device_path(monkeypatch):
    """bwt(device=true) runs the device SA/BWT at DEVICE_MIN and above
    (here through XLA on the CPU), byte-identical to the host path."""
    from tudocomp_tpu import cli
    from tudocomp_tpu.compressors.bwt import BWTCompressor
    from tudocomp_tpu.ops import suffix_jax

    calls = []
    real = suffix_jax.suffix_array_device
    monkeypatch.setattr(
        suffix_jax, "suffix_array_device",
        lambda t: calls.append(1) or real(t),
    )
    rng = np.random.default_rng(3)
    data = bytes(
        rng.choice(np.frombuffer(b"abcab ", np.uint8), BWTCompressor.DEVICE_MIN)
    )
    dev = cli.compress("bwt(device=true)", data, raw=True)
    assert calls, "the device SA did not run"
    assert dev == cli.compress("bwt", data, raw=True)
    assert cli.decompress(cli.compress("bwt(device=true)", data)) == data


def test_bwt_device_refuses_unknown_platform(monkeypatch):
    from tudocomp_tpu.compressors import REGISTRY

    monkeypatch.setattr(backend, "platform", _raise)
    comp = REGISTRY.instantiate("bwt(device=true)")
    with pytest.raises(RuntimeError):
        comp.compress(b"x" * (1 << 15) + b"\x00")


def _raise(name=None):
    raise RuntimeError("unsupported JAX platform")


def test_cache_dir_env_set():
    env = {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache",
           "JAX_PLATFORMS": "cpu"}
    assert cachedir.compile_cache_dir(env) == "/elsewhere/cache"


def test_cache_dir_env_unset():
    gpu = cachedir.compile_cache_dir({})
    assert gpu == os.path.join(ROOT, ".jax_cache")
    cpu = cachedir.compile_cache_dir({"JAX_PLATFORMS": "cpu"})
    assert os.path.dirname(cpu) == gpu
    assert os.path.basename(cpu).startswith("cpu-")


def _cache_dir_in_fresh_process(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax, tudocomp_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_cache_dir_rule_applied_on_import(tmp_path):
    """Set: JAX keeps the variable's directory and nothing replaces it.
    Unset: the package points JAX at the checkout's fixed directory."""
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)
    assert _cache_dir_in_fresh_process(None) == cachedir.compile_cache_dir(
        {"JAX_PLATFORMS": "cpu"}
    )
