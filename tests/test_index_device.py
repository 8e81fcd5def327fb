"""Device-side index build == host index build, bit for bit."""

import numpy as np

from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.kmers.encode import (
    encode_kmers,
    residues_to_indices,
)
from uniprot_kmer_based_clustering_tpu.kmers.index import build_index
from uniprot_kmer_based_clustering_tpu.kmers.index_device import (
    build_bitset_device,
)


def test_device_bitset_matches_host(rng):
    aas = "CSTAGPDEQNHRKMILVWYF"
    seqs = [
        "".join(aas[i] for i in rng.integers(0, 20, int(n)))
        for n in rng.integers(8, 60, 40)
    ]
    # inject heavy sharing
    seqs += [seqs[0][:30] + s[:20] for s in seqs[:10]]
    buf = np.frombuffer("".join(seqs).encode(), np.uint8)
    offs = np.cumsum([0] + [len(s) for s in seqs])
    n = len(seqs)

    # host path
    codes, koff = encode_kmers(buf, offs, 5)
    idx = build_index(codes, koff, 5)
    host_bs = pack_bitsets(
        idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
        row_multiple=8, word_multiple=128,
    )

    # device path
    lmax = max(len(s) for s in seqs)
    mat = np.zeros((n, lmax), np.int32)
    lengths = np.array([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        mat[i, : len(s)] = residues_to_indices(
            np.frombuffer(s.encode(), np.uint8)
        )
    words, freq, n_repeated = build_bitset_device(
        mat, lengths, n, row_multiple=8, word_multiple=128
    )
    assert n_repeated == idx.n_repeated
    freq = np.asarray(freq)
    assert np.array_equal(np.nonzero(freq)[0], idx.codes)
    assert np.array_equal(freq[idx.codes], idx.doc_freq)
    words = np.asarray(words)
    assert words.shape == host_bs.words.shape
    assert np.array_equal(words, host_bs.words)


def test_device_sorted_bitset_matches_host_k7(rng):
    """Sort-based device build (the k=7 path) == host, bit for bit."""
    from uniprot_kmer_based_clustering_tpu.kmers.index_device import (
        build_bitset_device_sorted,
    )

    aas = "CSTAGPDEQNHRKMILVWYF"
    seqs = [
        "".join(aas[i] for i in rng.integers(0, 20, int(n)))
        for n in rng.integers(10, 60, 40)
    ]
    seqs += [seqs[0][:30] + s[:20] for s in seqs[:10]]
    buf = np.frombuffer("".join(seqs).encode(), np.uint8)
    offs = np.cumsum([0] + [len(s) for s in seqs])
    n = len(seqs)

    for k in (5, 7):
        codes, koff = encode_kmers(buf, offs, k)
        idx = build_index(codes, koff, k)
        host_bs = pack_bitsets(
            idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
            row_multiple=8, word_multiple=128,
        )
        lmax = max(len(s) for s in seqs)
        mat = np.zeros((n, lmax), np.int32)
        lengths = np.array([len(s) for s in seqs], np.int32)
        for i, s in enumerate(seqs):
            mat[i, : len(s)] = residues_to_indices(
                np.frombuffer(s.encode(), np.uint8)
            )
        words, ucodes, counts, n_repeated = build_bitset_device_sorted(
            mat, lengths, n, k, row_multiple=8, word_multiple=128
        )
        assert n_repeated == idx.n_repeated, k
        assert np.array_equal(ucodes, idx.codes), k
        assert np.array_equal(counts, idx.doc_freq), k
        assert np.array_equal(np.asarray(words), host_bs.words), k


def test_pipeline_device_index_k7_matches_host(toy_fasta):
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    cfg = dict(tile=16, strip=32, engine="xla",
               threshold=2, k=7)
    r_host = run_pipeline(toy_fasta, PipelineConfig(**cfg))
    r_dev = run_pipeline(
        toy_fasta, PipelineConfig(**{**cfg, "index_engine": "device"})
    )
    assert r_host.parity_report() == r_dev.parity_report()
    assert np.array_equal(r_host.pairwise.pairs, r_dev.pairwise.pairs)
    assert np.array_equal(r_host.bitset.words, r_dev.bitset.words)


def test_sorted_build_empty_universe():
    """k=7 on sequences shorter than 7: empty index, all-zero bitset
    (regression: the sorted build gathered from zero-size arrays)."""
    from uniprot_kmer_based_clustering_tpu.kmers.index_device import (
        build_bitset_device_sorted,
    )

    mat = np.zeros((4, 6), np.int32)
    lengths = np.full(4, 6, np.int32)
    words, codes, counts, n_rep = build_bitset_device_sorted(
        mat, lengths, 4, 7, row_multiple=8, word_multiple=128
    )
    assert n_rep == 0
    assert codes.shape == (0,) and counts.shape == (0,)
    assert not np.asarray(words).any()


def test_sorted_build_matrix_narrower_than_k():
    """lmax ≤ k−2 (every sequence much shorter than k): the encode must
    not build a negative-width window matrix (regression: TypeError
    from jnp.zeros((n, -2)) before the empty-index early return)."""
    from uniprot_kmer_based_clustering_tpu.kmers.index_device import (
        build_bitset_device_sorted,
    )

    mat = np.zeros((3, 4), np.int32)
    lengths = np.full(3, 4, np.int32)
    words, codes, counts, n_rep = build_bitset_device_sorted(
        mat, lengths, 3, 7, row_multiple=8, word_multiple=128
    )
    assert n_rep == 0 and codes.shape == (0,)
    assert not np.asarray(words).any()


def test_encode_device_rejects_k_over_7():
    """21^8 > 2^31 would silently wrap the int32 stencil — corrupt index
    with no error; must refuse instead."""
    import pytest

    from uniprot_kmer_based_clustering_tpu.kmers.encode import (
        encode_kmers_device,
    )

    with pytest.raises(ValueError, match="overflows int32"):
        encode_kmers_device(np.zeros((2, 16), np.int32),
                            np.full(2, 16, np.int32), 8)


def test_flat_index_space_guard():
    import pytest

    from uniprot_kmer_based_clustering_tpu.kmers.index_device import (
        _check_flat_index_space,
    )

    _check_flat_index_space(100_352, 16_384)  # the documented 100k scale
    with pytest.raises(ValueError, match="2\\^31"):
        _check_flat_index_space(100_352, 62_592)
