"""Batched matmul agglomerative clustering: oracle, invariants, CLI."""

import numpy as np

from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.models.agglomerative import (
    agglomerative_cluster,
)


def _bitset(rows, cols, n, k):
    return pack_bitsets(
        np.asarray(rows, np.int32), np.asarray(cols, np.int32), n, k,
        row_multiple=8, word_multiple=128,
    )


def _oracle(memb_bits, min_shared):
    """Per-round mutual-argmax merges in pure numpy — the independent
    reference for the device implementation."""
    sigs = [b.copy() for b in memb_bits]
    active = [True] * len(sigs)
    parent = list(range(len(sigs)))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    merges = []
    while True:
        n = len(sigs)
        best_j = [-1] * n
        best_c = [-1] * n
        for i in range(n):
            if not active[i]:
                continue
            for j in range(n):
                if j == i or not active[j]:
                    continue
                c = int(np.sum(sigs[i] & sigs[j]))
                if c > best_c[i]:
                    best_c[i] = c
                    best_j[i] = j
        pairs = [
            (i, best_j[i])
            for i in range(n)
            if active[i]
            and best_c[i] >= min_shared
            and best_j[i] >= 0
            and best_j[best_j[i]] == i
            and i < best_j[i]
        ]
        if not pairs:
            break
        for i, j in pairs:
            merges.append((i, j, best_c[i]))
            sigs[i] = sigs[i] & sigs[j]
            active[j] = False
            parent[find(j)] = find(i)
    labels = []
    roots = {}
    for i in range(len(sigs)):
        r = find(i)
        roots.setdefault(r, i)
        labels.append(roots[r])
    return np.asarray(labels), merges


def test_matches_numpy_oracle(rng):
    n, k = 24, 96
    dense = (rng.random((n, k)) < 0.25)
    # plant two tight families
    dense[1] = dense[0]
    dense[2] = dense[0] | (rng.random(k) < 0.05)
    dense[5] = dense[4]
    rows, cols = np.nonzero(dense)
    bs = _bitset(rows, cols, n, k)
    res = agglomerative_cluster(bs, n, min_shared=3)

    memb = [dense[i].astype(bool) for i in range(n)]
    labels_ref, merges_ref = _oracle(memb, 3)
    assert np.array_equal(res.labels, labels_ref)
    assert [tuple(m) for m in res.merges] == merges_ref


def test_identical_rows_merge_disjoint_stay():
    n, k = 8, 64
    dense = np.zeros((n, k), bool)
    dense[0, :10] = True
    dense[1, :10] = True           # == row 0
    dense[2, 20:30] = True         # disjoint
    dense[3, 40:45] = True
    rows, cols = np.nonzero(dense)
    bs = _bitset(rows, cols, n, k)
    res = agglomerative_cluster(bs, n, min_shared=1)
    assert res.labels[0] == res.labels[1] == 0
    assert len({res.labels[2], res.labels[3], res.labels[0]}) == 3
    # empty rows never merge (zero signatures share nothing)
    assert res.labels[4] == 4

    # dendrogram bookkeeping: one merge per lost cluster
    n_clusters = len(np.unique(res.labels))
    assert res.merges.shape[0] == n - n_clusters


def test_deterministic(rng):
    n, k = 32, 128
    rows, cols = np.nonzero(rng.random((n, k)) < 0.2)
    bs = _bitset(rows, cols, n, k)
    a = agglomerative_cluster(bs, n, min_shared=2)
    b = agglomerative_cluster(bs, n, min_shared=2)
    assert np.array_equal(a.labels, b.labels)
    assert np.array_equal(a.merges, b.merges)
    assert a.rounds == b.rounds


def test_cli_agglomerative(toy_fasta, tmp_path):
    import os

    from uniprot_kmer_based_clustering_tpu.cli import main

    out = str(tmp_path / "out_agg")
    rc = main([
        "run", toy_fasta, "--engine", "xla", "--threshold", "2",
        "--cluster", "agglomerative", "--out", out, "--cpu",
    ])
    assert rc == 0
    rows = open(os.path.join(out, "clusters.tsv")).read().splitlines()[1:]
    labels = {int(r.split("\t")[0]): int(r.split("\t")[3]) for r in rows}
    assert len(labels) == 60
    # toy data is built from 4 shared templates → strong merging
    assert len(set(labels.values())) < 60


def test_device_loop_matches_host_loop(rng):
    """lax.while_loop implementation == the host-looped version, for
    labels, dendrogram, and round count."""
    from uniprot_kmer_based_clustering_tpu.models.agglomerative import (
        agglomerative_cluster_device,
    )

    for seed, min_shared in ((1, 1), (2, 3), (3, 2)):
        r = np.random.default_rng(seed)
        n, k = 40, 160
        dense = r.random((n, k)) < 0.2
        dense[1] = dense[0]
        dense[7] = dense[6] | (r.random(k) < 0.05)
        rows, cols = np.nonzero(dense)
        bs = _bitset(rows, cols, n, k)
        a = agglomerative_cluster(bs, n, min_shared=min_shared)
        b = agglomerative_cluster_device(bs, n, min_shared=min_shared)
        assert np.array_equal(a.labels, b.labels), (seed, min_shared)
        assert np.array_equal(a.merges, b.merges), (seed, min_shared)
        assert a.rounds == b.rounds, (seed, min_shared)


def test_cli_dendrogram_output(toy_fasta, tmp_path):
    import os

    from uniprot_kmer_based_clustering_tpu.cli import main

    out = str(tmp_path / "out_dendro")
    rc = main([
        "run", toy_fasta, "--engine", "xla", "--threshold", "2",
        "--cluster", "agglomerative", "--out", out, "--cpu",
    ])
    assert rc == 0
    rows = open(os.path.join(out, "dendrogram.tsv")).read().strip().splitlines()
    assert rows[0] == "winner\tloser\tshared_kmers"
    crows = open(os.path.join(out, "clusters.tsv")).read().strip().splitlines()[1:]
    n_clusters = len({r.split("\t")[3] for r in crows})
    assert len(rows) - 1 == 60 - n_clusters  # one merge per lost cluster
    for r in rows[1:]:
        w, l, c = map(int, r.split("\t"))
        assert w < l and c >= 1


def test_cli_min_shared_gate(toy_fasta, tmp_path):
    """Raising --min-shared can only produce more (or equal) clusters."""
    import os

    from uniprot_kmer_based_clustering_tpu.cli import main

    counts = {}
    for ms in (1, 40):
        out = str(tmp_path / f"out_ms{ms}")
        rc = main([
            "run", toy_fasta, "--engine", "xla", "--threshold", "2",
            "--cluster", "agglomerative", "--min-shared", str(ms),
            "--out", out, "--cpu",
        ])
        assert rc == 0
        rows = open(os.path.join(out, "clusters.tsv")).read().splitlines()[1:]
        counts[ms] = len({r.split("\t")[3] for r in rows})
    assert counts[40] >= counts[1]


def test_strip_mode_matches_one_shot(rng):
    """The beyond-bundled-scale strip argmax (forced via a tiny HBM
    budget → _argmax_plan returns a strip/word_chunk plan) must produce
    the IDENTICAL merge sequence, dendrogram and labels as the one-shot
    matmul — counts are the same integer sums, so argmax and ties
    cannot differ."""
    from uniprot_kmer_based_clustering_tpu.models.agglomerative import (
        _argmax_plan,
    )

    n, k = 600, 2048  # n_pad > 512: multi-strip, incl. the clamped tail
    rows, cols = np.nonzero(rng.random((n, k)) < 0.05)
    bs = _bitset(rows, cols, n, k)
    ref = agglomerative_cluster(bs, n, min_shared=2)
    tiny = 1 << 20  # forces the strip plan AND a word_chunk here
    assert _argmax_plan(bs.words.shape[0], bs.words.shape[1], tiny)
    got = agglomerative_cluster(
        bs, n, min_shared=2, hbm_budget_bytes=tiny
    )
    assert np.array_equal(got.labels, ref.labels)
    assert np.array_equal(got.merges, ref.merges)
    assert got.rounds == ref.rounds
