"""Fused extraction (in-sweep top-k compaction) vs the two-pass extractor.

The fused path (bitmul._scan_sweep fused_k / pairwise.extract_pairs_fused)
must be bit-identical to two-pass extraction in every regime: pure
compaction (all sub-tiles fit the capacity), overflow redo (some don't),
same-class pairs included, and the pipeline-level auto fallback when the
schedule resolves to strips. Mirrors the reference's exactness contract
for the surviving pair set (count > threshold, cross-AMR —
src/graph/mod.rs:242,580-587).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu
from uniprot_kmer_based_clustering_tpu.similarity import (
    extract_pairs_fused,
    pairwise_similarity,
)
from uniprot_kmer_based_clustering_tpu.similarity.pairwise import extract_pairs


def _dense_problem(seed=5, n_pad=128, w=8, n=120):
    """Near-identical rows: every tile reports hits (dense-homology)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    words = np.tile(base, (n_pad, 1))
    flip = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words ^= np.where(rng.random((n_pad, w)) < 0.05, flip, 0).astype(np.uint32)
    words[n:] = 0
    classes = rng.integers(0, 3, size=n_pad).astype(np.int32)
    classes[n:] = -1
    return words, classes


def _brute(words, classes, n, thr, cross_only=True):
    bits = np.unpackbits(
        words[:n].view(np.uint8), axis=1, bitorder="little"
    ).astype(np.int64)
    counts = bits @ bits.T
    exp = []
    for i in range(n):
        for j in range(i + 1, n):
            ok = classes[i] != classes[j] or not cross_only
            if counts[i, j] > thr and ok:
                exp.append((i, j, counts[i, j]))
    return np.array(exp, np.int64).reshape(-1, 3)


def _run_fused(words, classes, n, thr, fused_k, fused_same=False):
    rs, th, tiles, cands = sweep_mxu(
        jnp.asarray(words), jnp.asarray(classes), n, thr,
        strip=32, block=16, schedule="scan",
        fused_k=fused_k, fused_same=fused_same,
    )
    assert cands is not None, "scan schedule must support fusion"
    got = extract_pairs_fused(
        jnp.asarray(words), classes, th, tiles, cands,
        n=n, threshold=thr, cross_amr_only=not fused_same,
    )
    two_pass = extract_pairs(
        jnp.asarray(words), classes, th, tiles, n=n, threshold=thr,
        cross_amr_only=not fused_same,
    )
    return got, two_pass, th, cands


def test_fused_no_overflow_matches_two_pass_and_brute():
    words, classes = _dense_problem()
    thr = 40
    got, two_pass, th, cands = _run_fused(words, classes, 120, thr, 256)
    assert cands.k == 256  # block²: no sub-tile can ever overflow
    assert np.array_equal(got, two_pass)
    assert np.array_equal(got, _brute(words, classes, 120, thr))
    assert len(got) > 0


def test_fused_overflow_redo_matches_two_pass():
    words, classes = _dense_problem()
    thr = 40
    got, two_pass, th, cands = _run_fused(words, classes, 120, thr, 96)
    hits = th[:, 0]
    # the capacity guess must actually be exceeded somewhere AND
    # respected somewhere, so both recovery paths run
    assert (hits > 96).any() and ((hits > 0) & (hits <= 96)).any()
    assert np.array_equal(got, two_pass)


def test_fused_same_class_pairs_included():
    words, classes = _dense_problem(seed=9)
    thr = 40
    got, two_pass, th, _ = _run_fused(
        words, classes, 120, thr, 8, fused_same=True
    )
    assert np.array_equal(got, two_pass)
    assert np.array_equal(
        got, _brute(words, classes, 120, thr, cross_only=False)
    )


def test_fused_capacity_clamped_to_subtile():
    # capacity beyond block² is meaningless; top_k must not blow up
    words, classes = _dense_problem(seed=3)
    got, two_pass, _, cands = _run_fused(words, classes, 120, 40, 100000)
    assert cands.k == 256
    assert np.array_equal(got, two_pass)


def test_pipeline_fused_matches_two_pass():
    """End-to-end through pairwise_similarity: the scan schedule engages
    (ns > 8 strips) and extract='fused' auto-sizes its capacity."""
    rng = np.random.default_rng(21)
    n, k = 300, 900
    rows, cols = np.nonzero(rng.random((n, k)) < 0.08)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    base = PipelineConfig(
        threshold=3, tile=16, engine="mxu", strip=16
    )
    r_two = pairwise_similarity(bs, classes, base)
    for extract_k in (0, 8):  # auto-sized and explicitly tiny (overflow)
        cfg = PipelineConfig(
            threshold=3, tile=16, engine="mxu", strip=16,
            extract="fused", extract_k=extract_k,
        )
        r_fused = pairwise_similarity(bs, classes, cfg)
        assert np.array_equal(r_fused.pairs, r_two.pairs)
        assert r_fused.cross_over == r_two.cross_over
    assert len(r_two.pairs) > 0


def test_pipeline_fused_falls_back_on_strip_schedule():
    """A corpus too small for the scan schedule must silently fall back
    to two-pass extraction and stay exact."""
    rng = np.random.default_rng(0)
    n, k = 70, 900
    rows, cols = np.nonzero(rng.random((n, k)) < 0.05)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    r_two = pairwise_similarity(
        bs, classes,
        PipelineConfig(threshold=3, tile=16, engine="mxu"),
    )
    r_fused = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=3, tile=16, engine="mxu",
            extract="fused",
        ),
    )
    assert np.array_equal(r_fused.pairs, r_two.pairs)


def test_pipeline_fused_weighted_matches_two_pass():
    """BLOSUM-weighted scores ride the fused candidates too: the sweep's
    counts ARE the weighted scores (int8 column scale on one operand), so
    fused extraction must stay bit-identical in weighted mode — including
    the overflow redo, which must thread the weights through the two-pass
    recompute."""
    rng = np.random.default_rng(13)
    n, k = 300, 896
    rows, cols = np.nonzero(rng.random((n, k)) < 0.08)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    w = rng.integers(1, 6, bs.words.shape[1] * 32).astype(np.int8)
    base = PipelineConfig(
        threshold=3, tile=16, engine="mxu", strip=16
    )
    r_two = pairwise_similarity(bs, classes, base, weights=w)
    for extract_k in (0, 8):  # auto-sized and explicitly tiny (overflow)
        cfg = PipelineConfig(
            threshold=3, tile=16, engine="mxu", strip=16,
            extract="fused", extract_k=extract_k,
        )
        r_fused = pairwise_similarity(bs, classes, cfg, weights=w)
        assert np.array_equal(r_fused.pairs, r_two.pairs)
    assert len(r_two.pairs) > 0


def test_config_rejects_bad_extract():
    with pytest.raises(ValueError, match="extract"):
        PipelineConfig(extract="nope")
    with pytest.raises(ValueError, match="extract_k"):
        PipelineConfig(extract_k=-1)
