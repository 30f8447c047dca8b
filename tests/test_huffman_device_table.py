"""Device table build == host HuffmanTable.from_counts, bit-exact.

The encode pipeline's one host step is the canonical-table build from
the device histogram (a device->host sync mid-stream). The device
construction (ops/huffman_jax.py device_table_build) must agree
with the host path EXACTLY — the container serializes the host-built
table, so any divergence corrupts streams.
"""

from __future__ import annotations

import numpy as np
import pytest

from tudocomp_tpu.coders.huffman import HuffmanTable


def _host(hist, max_len=16, min_len=3):
    t = HuffmanTable.from_counts(hist, max_len=max_len, min_len=min_len)
    return t.sym_code.astype(np.uint32), t.sym_len.astype(np.uint32)


def _device(hist, max_len=16, min_len=3):
    import jax.numpy as jnp

    from tudocomp_tpu.ops.huffman_jax import device_table_build

    code, ln = device_table_build(
        jnp.asarray(hist.astype(np.int32)), max_len=max_len,
        min_len=min_len,
    )
    return np.asarray(code), np.asarray(ln)


def _check(hist, **kw):
    hc, hl = _host(hist, **kw)
    dc, dl = _device(hist, **kw)
    np.testing.assert_array_equal(hl, dl)
    np.testing.assert_array_equal(hc, dc)


def test_uniform():
    _check(np.ones(256, np.int64))


def test_random_hists():
    rng = np.random.default_rng(0)
    for _ in range(20):
        h = rng.integers(1, 1 << 20, 256).astype(np.int64)
        _check(h)


def test_heavy_ties():
    # many equal counts exercise the heap tie-break (leaf-before-merged,
    # ascending symbol among leaves)
    rng = np.random.default_rng(1)
    for _ in range(10):
        h = rng.integers(1, 4, 256).astype(np.int64)
        _check(h)


def test_skewed_triggers_length_limit():
    # near-Fibonacci counts force deep optimal codes -> the (c+1)//2
    # halving loop must run identically on both sides
    h = np.ones(256, np.int64)
    f = 1
    g = 1
    for i in range(40):
        h[i] = f
        f, g = f + g, f
    _check(h)
    _check(h[::-1].copy())


def test_text_like():
    rng = np.random.default_rng(2)
    text = rng.zipf(1.3, 1 << 16) % 256
    h = np.bincount(text, minlength=256) + 1  # the sampled+1 path
    _check(h)


@pytest.mark.parametrize("min_len", [3, 4, 8])
def test_min_len_variants(min_len):
    rng = np.random.default_rng(3)
    h = rng.integers(1, 1000, 256).astype(np.int64)
    _check(h, min_len=min_len)
