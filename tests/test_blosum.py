"""BLOSUM62-weighted similarity (reference capability: src/blosum.rs)."""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.similarity import pairwise_similarity
from uniprot_kmer_based_clustering_tpu.utils.blosum import (
    BLOSUM62_ALPHABET,
    blosum62_matrix,
    kmer_self_scores,
    rank_weights_int8,
)


def test_matrix_symmetric_and_reference_values():
    m = blosum62_matrix()
    assert np.array_equal(m, m.T)
    a = BLOSUM62_ALPHABET
    # spot values from the reference table (src/blosum.rs:10-29)
    assert m[a.index("C"), a.index("C")] == 9
    assert m[a.index("W"), a.index("W")] == 11
    assert m[a.index("E"), a.index("C")] == -4
    assert m[a.index("F"), a.index("Y")] == 3
    assert m[a.index("S"), a.index("T")] == 1
    # '*' per NCBI extension: −4 vs residues, +1 vs itself
    assert (m[20, :20] == -4).all() and m[20, 20] == 1


def test_kmer_self_scores():
    from uniprot_kmer_based_clustering_tpu.kmers.encode import encode_kmers

    buf = np.frombuffer(b"CWAGP", np.uint8)
    codes, _ = encode_kmers(buf, np.array([0, 5]), 5)
    # C=9 W=11 A=4 G=6 P=7 → 37
    assert kmer_self_scores(codes, 5).tolist() == [37]
    # weights bounded for int8
    assert kmer_self_scores(codes, 5).max() <= 55


@pytest.fixture(scope="module")
def wproblem():
    rng = np.random.default_rng(4)
    n, k_bits = 60, 600
    rows, cols = np.nonzero(rng.random((n, k_bits)) < 0.06)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k_bits,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    weights = rng.integers(4, 56, bs.w_pad * 32).astype(np.int8)
    weights[k_bits:] = 0
    sets = [set(cols[rows == i].tolist()) for i in range(n)]
    return bs, classes, weights, sets


def _brute_weighted(sets, classes, weights, thr):
    n = len(sets)
    cw = cp = co = cm = 0
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            if classes[i] == classes[j]:
                continue
            s = int(sum(int(weights[k]) for k in (sets[i] & sets[j])))
            cw += s
            cp += s >= 1
            co += s > thr
            cm = max(cm, s)
            if s > thr:
                pairs.append((i, j, s))
    return cw, cp, co, cm, np.array(pairs, np.int64).reshape(-1, 3)


def test_weighted_matches_brute_force(wproblem):
    bs, classes, weights, sets = wproblem
    thr = 60
    cw, cp, co, cm, pairs = _brute_weighted(sets, classes, weights, thr)
    cfg = PipelineConfig(
        threshold=10, weighted_threshold=thr, weighting="blosum62",
        tile=16, strip=16, engine="mxu",
    )
    r = pairwise_similarity(bs, classes, cfg, weights=weights)
    assert (r.cross_weight, r.cross_pairs, r.cross_over, r.cross_max) == (
        cw, cp, co, cm,
    )
    assert np.array_equal(r.pairs, pairs)


def test_weighted_ring_sweep_matches(wproblem):
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh,
        sharded_pairwise_similarity,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        extract_pairs,
    )
    import jax.numpy as jnp

    bs, classes, weights, sets = wproblem
    thr = 60
    cw, cp, co, cm, pairs = _brute_weighted(sets, classes, weights, thr)
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    mesh = make_mesh(4)
    rs, th, tl = sharded_pairwise_similarity(
        mesh, bs.words, cls, bs.n, thr, block_tile=16, weights=weights
    )
    tot = rs.sum(axis=0)
    assert (tot[0], tot[1], tot[2]) == (cw, cp, co)
    assert rs[:, 3].max() == cm
    got = extract_pairs(
        jnp.asarray(bs.words), cls, th, tl, n=bs.n, threshold=thr,
        weights=weights,
    )
    assert np.array_equal(got, pairs)


def test_pipeline_weighted_e2e(toy_fasta):
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    cfg = PipelineConfig(
        weighting="blosum62", threshold=2, weighted_threshold=80,
        tile=16, strip=32, engine="mxu",
    )
    r = run_pipeline(toy_fasta, cfg)
    raw = run_pipeline(
        toy_fasta,
        PipelineConfig(threshold=2, tile=16, strip=32, 
                       engine="xla"),
    )
    # same pair support (weights are strictly positive), different scores
    assert r.pairwise.cross_pairs == raw.pairwise.cross_pairs
    assert r.pairwise.cross_weight > raw.pairwise.cross_weight
    if len(r.pairwise.pairs):
        assert r.pairwise.pairs[:, 2].min() > 80


import pytest


@pytest.mark.golden
def test_golden_weighted_full_dataset(arg_fasta):
    """BLOSUM62-weighted config (BASELINE config #3) full-dataset
    constants, derived via the scipy oracle and cross-checked against
    the device matmul engine: Σ weighted cross score 124,363,524; pairs over
    the scaled gate (10 × mean weight) 465; max weighted score 14,781."""
    import numpy as np
    import scipy.sparse as sp

    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
    )
    from uniprot_kmer_based_clustering_tpu.utils.blosum import (
        rank_weights_int8,
    )

    table = read_fasta(arg_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)
    w_bits = -(-idx.n_repeated // 32) * 32
    wts = rank_weights_int8(idx.repeated_codes, 5, w_bits)

    b = sp.csr_matrix(
        (
            wts[idx.incidence_rank].astype(np.int64),
            (idx.incidence_protein, idx.incidence_rank),
        ),
        shape=(table.n, idx.n_repeated),
    )
    u = sp.csr_matrix(
        (
            np.ones(idx.nnz, np.int64),
            (idx.incidence_protein, idx.incidence_rank),
        ),
        shape=(table.n, idx.n_repeated),
    )
    c = (b @ u.T).tocoo()
    i, j, v = c.row, c.col, c.data
    m = i < j
    cls = table.amr_class_ids
    cross = cls[i[m]] != cls[j[m]]
    vm = v[m][cross]
    gate = PipelineConfig(weighting="blosum62").effective_weighted_threshold(
        wts
    )
    assert int(vm.sum()) == 124363524
    assert int((vm > gate).sum()) == 465
    assert int(vm.max()) == 14781
