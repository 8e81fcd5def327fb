"""Pairwise sweep engines vs brute force: all engines must agree exactly."""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.similarity import pairwise_similarity

THR = 3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, k = 70, 900
    rows, cols = np.nonzero(rng.random((n, k)) < 0.05)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    sets = [set(cols[rows == i].tolist()) for i in range(n)]
    brute = {
        "cw": 0, "cp": 0, "co": 0, "cm": 0,
        "sw": 0, "sp": 0, "so": 0, "sm": 0,
    }
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            c = len(sets[i] & sets[j])
            if classes[i] != classes[j]:
                brute["cw"] += c
                brute["cp"] += c > 0
                brute["co"] += c > THR
                brute["cm"] = max(brute["cm"], c)
                if c > THR:
                    pairs.append((i, j, c))
            else:
                brute["sw"] += c
                brute["sp"] += c > 0
                brute["so"] += c > THR
                brute["sm"] = max(brute["sm"], c)
    return bs, classes, brute, np.array(pairs, np.int64)


def _check(result, brute, pairs):
    assert result.cross_weight == brute["cw"]
    assert result.cross_pairs == brute["cp"]
    assert result.cross_over == brute["co"]
    assert result.cross_max == brute["cm"]
    assert result.same_weight == brute["sw"]
    assert result.same_pairs == brute["sp"]
    assert result.same_over == brute["so"]
    assert result.same_max == brute["sm"]
    assert np.array_equal(result.pairs, pairs)


def test_xla_engine(problem):
    bs, classes, brute, pairs = problem
    cfg = PipelineConfig(threshold=THR, tile=16, engine="xla")
    _check(pairwise_similarity(bs, classes, cfg), brute, pairs)


def test_mxu_engine_on_cpu(problem):
    # the int8 matmul formulation runs anywhere XLA does
    bs, classes, brute, pairs = problem
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        extract_pairs,
    )
    import jax.numpy as jnp

    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles = sweep_mxu(
        jnp.asarray(bs.words), jnp.asarray(cls), bs.n, THR,
        strip=16, block=16,
    )
    tot = rs.sum(axis=0)
    assert (tot[0], tot[1], tot[2]) == (brute["cw"], brute["cp"], brute["co"])
    assert rs[:, 3].max() == brute["cm"]
    got = extract_pairs(
        jnp.asarray(bs.words), cls, th, tiles, n=bs.n, threshold=THR
    )
    assert np.array_equal(got, pairs)


def test_cross_amr_only_false(problem):
    bs, classes, brute, _ = problem
    cfg = PipelineConfig(
        threshold=THR, tile=16, engine="xla",
        cross_amr_only=False,
    )
    r = pairwise_similarity(bs, classes, cfg)
    assert r.pairs.shape[0] == brute["co"] + brute["so"]


def test_threshold_zero_includes_all_sharing_pairs(problem):
    bs, classes, brute, _ = problem
    cfg = PipelineConfig(
        threshold=0, tile=16, engine="xla"
    )
    r = pairwise_similarity(bs, classes, cfg)
    assert r.pairs.shape[0] == brute["cp"]
    assert r.pairs[:, 2].min() >= 1


def test_extract_pairs_accepts_length_n_classes():
    """Public-API contract: classes may be length n (not n_pad); edge
    tiles must not silently misalign (lax.dynamic_slice clamps)."""
    import jax.numpy as jnp
    import numpy as np

    from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
    from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        extract_pairs,
    )

    rng = np.random.default_rng(21)
    n, k = 300, 900  # n_pad rounds to 512 — the last tile is mostly pad
    rows, cols = np.nonzero(rng.random((n, k)) < 0.08)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=512, word_multiple=128,
    )
    classes_n = rng.integers(0, 3, n).astype(np.int32)
    classes_pad = np.full(bs.n_pad, -1, np.int32)
    classes_pad[:n] = classes_n
    w = jnp.asarray(bs.words)
    rs, th, tl = sweep_xla(w, jnp.asarray(classes_pad), n, 3, tile=128)
    p_pad = extract_pairs(w, classes_pad, th, tl, n=n, threshold=3)
    p_n = extract_pairs(w, classes_n, th, tl, n=n, threshold=3)
    assert len(p_pad) > 0
    assert np.array_equal(p_pad, p_n)


def test_sweep_xla_rejects_misaligned_tile():
    """n_pad not a multiple of tile must fail loudly — a floored tile
    grid would silently skip tail rows (or sweep nothing at all)."""
    import jax.numpy as jnp
    import pytest

    from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla

    w = jnp.zeros((96, 8), jnp.uint32)
    with pytest.raises(ValueError, match="multiple of tile"):
        sweep_xla(w, jnp.full(96, -1, jnp.int32), 90, 3, tile=64)


def test_extract_pairs_coalesced_matches_bruteforce():
    """Dense hit patterns trigger superblock coalescing in extraction;
    the recovered pairs must equal the brute-force popcount oracle."""
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _coalesce_hit_tiles,
        extract_pairs,
    )

    rng = np.random.default_rng(5)
    n_pad, w, n = 128, 8, 120
    # near-identical rows -> every tile reports hits (dense regime)
    base = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    words = np.tile(base, (n_pad, 1))
    flip = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words ^= np.where(rng.random((n_pad, w)) < 0.05, flip, 0).astype(np.uint32)
    words[n:] = 0
    classes = rng.integers(0, 3, size=n_pad).astype(np.int32)
    classes[n:] = -1

    rs, th, tl = sweep_xla(jnp.asarray(words), classes, n, 40, tile=16)
    ti, tj, tile = tl
    want = th[:, 0] > 0
    assert _coalesce_hit_tiles(
        np.asarray(ti), np.asarray(tj), want,
        th[:, 0].astype(np.int64), tile, n_pad,
    ) is not None, "test case must actually exercise the coalesced path"

    # force both default strategies explicitly for path coverage, and
    # check the plain scatter path agrees
    pairs = extract_pairs(
        jnp.asarray(words), classes, th, tl, n=n, threshold=40,
        coalesce=True, use_topk=True,
    )
    pairs_scatter = extract_pairs(
        jnp.asarray(words), classes, th, tl, n=n, threshold=40,
        coalesce=False, use_topk=False,
    )
    assert np.array_equal(pairs, pairs_scatter)

    # brute-force oracle
    bits = np.unpackbits(
        words[:n].view(np.uint8), axis=1, bitorder="little"
    ).astype(np.int64)
    counts = bits @ bits.T
    exp = []
    for i in range(n):
        for j in range(i + 1, n):
            if counts[i, j] > 40 and classes[i] != classes[j]:
                exp.append((i, j, counts[i, j]))
    assert np.array_equal(pairs, np.array(exp, np.int64).reshape(-1, 3))
