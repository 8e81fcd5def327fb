"""Connected-components clustering tests."""

import numpy as np

from uniprot_kmer_based_clustering_tpu.models.components import (
    connected_components,
    connected_components_device,
)


def _random_graph(rng, n, m):
    pairs = rng.integers(0, n, (m, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return pairs


def test_union_find_basic():
    labels = connected_components(6, np.array([[0, 1], [1, 2], [4, 5]]))
    assert labels.tolist() == [0, 0, 0, 3, 4, 4]


def test_empty_graph():
    labels = connected_components(4, np.zeros((0, 2), np.int64))
    assert labels.tolist() == [0, 1, 2, 3]


def test_device_matches_host(rng):
    n = 200
    for m in (0, 10, 100, 400):
        pairs = _random_graph(rng, n, m)
        host = connected_components(n, pairs)
        if len(pairs) == 0:
            pairs = np.array([[0, 0]])  # device path needs ≥1 edge; self-loop is a no-op
        dev = np.asarray(
            connected_components_device(
                pairs[:, 0].astype(np.int32),
                pairs[:, 1].astype(np.int32),
                n=n,
            )
        )
        assert np.array_equal(host, dev)


def test_min_label_is_canonical(rng):
    n = 50
    pairs = _random_graph(rng, n, 80)
    labels = connected_components(n, pairs)
    for lbl in np.unique(labels):
        members = np.nonzero(labels == lbl)[0]
        assert members.min() == lbl


def test_sharded_matches_host(rng):
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components_sharded,
    )
    from uniprot_kmer_based_clustering_tpu.parallel import make_mesh

    n = 300
    m = 450
    pairs = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    ref = connected_components(n, pairs)
    for d in (1, 3, 8):
        mesh = make_mesh(d)
        got = connected_components_sharded(mesh, pairs, n)
        assert np.array_equal(ref, got), d


import pytest


@pytest.mark.golden
def test_golden_cluster_structures_full_dataset(arg_fasta):
    """Full-dataset cluster structure constants for all three models
    (self-derived, deterministic — regression anchors):
      * components over the 465 surviving pairs: 10,156 clusters
        (largest 458, singletons 10,153 — most proteins never clear the
        >10 gate);
      * tree (src/tree.rs exact semantics, file order): 178 root
        children.
    (The agglomerative model's full-dataset constant — 123 clusters —
    is gated by bench_engines.py on the device only: its per-round
    full-square signature matmul is impractical on the CPU test
    runner.)"""
    import numpy as np

    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components,
    )
    from uniprot_kmer_based_clustering_tpu.models.tree import (
        cluster_tree_labels,
    )

    import scipy.sparse as sp

    table = read_fasta(arg_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)

    # surviving pairs via the scipy oracle (fast, engine-independent)
    b = sp.csr_matrix(
        (
            np.ones(idx.nnz, np.int32),
            (idx.incidence_protein, idx.incidence_rank),
        ),
        shape=(table.n, idx.n_repeated),
    )
    c = (b @ b.T).tocoo()
    i, j, v = c.row, c.col, c.data
    m = (i < j) & (v > 10)
    cls = table.amr_class_ids
    keep = m & (cls[i] != cls[j])
    pairs = np.stack([i[keep], j[keep]], axis=1).astype(np.int64)
    assert pairs.shape[0] == 465

    labels = connected_components(table.n, pairs)
    uniq, counts = np.unique(labels, return_counts=True)
    assert (len(uniq), int(counts.max()), int((counts == 1).sum())) == (
        10156, 458, 10153,
    )

    bs = pack_bitsets(
        idx.incidence_protein, idx.incidence_rank, table.n,
        idx.n_repeated, row_multiple=8, word_multiple=128,
    )
    tl = cluster_tree_labels(bs, table.n)
    assert len(np.unique(tl)) == 178
