"""Schedules of the int8 matmul sweep (strips, word chunks, the one-shape
block-pair scan) agree exactly with the AND+popcount oracle
(ops.popcount.sweep_xla)."""

import numpy as np
import jax.numpy as jnp
import pytest

from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu
from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla


@pytest.fixture(scope="module")
def small_case():
    rng = np.random.default_rng(7)
    n_pad, w = 1536, 64
    n = 1500
    words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words[n:] = 0
    classes = rng.integers(0, 4, size=n_pad).astype(np.int32)
    classes[n:] = -1
    rs, th, tiles = sweep_xla(jnp.asarray(words), classes, n, 10, tile=512)
    return words, classes, n, rs, th, tiles


def test_sweep_mxu_strip_schedules_agree(small_case):
    words, classes, n, rs_ref, th_ref, _ = small_case
    for strip in (512, 1536):
        rs, th, _ = sweep_mxu(
            jnp.asarray(words), jnp.asarray(classes), n, 10, strip=strip
        )
        assert np.array_equal(rs_ref, rs), strip
        assert np.array_equal(th_ref[:, :2], th), strip


def test_word_chunked_sweep_matches_unchunked(small_case):
    """Contraction-axis chunking (the memory-bounded scale path) is exact."""
    words, classes, n, rs_ref, th_ref, _ = small_case
    for wc in (128, 256):
        rs, th, _ = sweep_mxu(
            jnp.asarray(words), jnp.asarray(classes), n, 10,
            strip=words.shape[0], word_chunk=wc,
        )
        assert np.array_equal(rs_ref, rs), wc
        assert np.array_equal(th_ref[:, :2], th), wc


def test_word_chunked_weighted_matches(small_case):
    words, classes, n, _, _, _ = small_case
    rng = np.random.default_rng(3)
    wts = rng.integers(1, 50, size=words.shape[1] * 32).astype(np.int8)
    ref = sweep_mxu(
        jnp.asarray(words), jnp.asarray(classes), n, 100,
        weights=wts, strip=words.shape[0],
    )
    got = sweep_mxu(
        jnp.asarray(words), jnp.asarray(classes), n, 100,
        weights=wts, strip=words.shape[0], word_chunk=128,
    )
    assert np.array_equal(ref[0], got[0])
    assert np.array_equal(ref[1], got[1])


def test_scan_schedule_matches(small_case):
    """One-compiled-shape block-pair scan == strip schedule == oracle."""
    words, classes, n, rs_ref, th_ref, _ = small_case
    for wc in (0, 32):
        rs, th, _ = sweep_mxu(
            jnp.asarray(words), jnp.asarray(classes), n, 10,
            strip=512, schedule="scan", word_chunk=wc,
        )
        assert np.array_equal(rs_ref, rs), wc
        assert np.array_equal(th_ref[:, :2], th), wc
