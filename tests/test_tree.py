"""Cluster-tree tests: cached implementation vs direct transcription of
src/tree.rs, plus structural invariants."""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.models.tree import (
    ClusterTree,
    build_tree,
)


def _popcount_and(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.bitwise_count(a & b).sum())


# --- direct (cache-free) transcription of the reference semantics -------
class _RefNode:
    def __init__(self, u, c, protein):
        self.children, self.u, self.c, self.protein = [], u, c, protein


def _ref_add_child(curr, child):
    if not curr.children:
        cloned = _RefNode(curr.u, curr.c, curr.protein)
        curr.protein = None
        curr.u = curr.u | child.u
        curr.c = curr.c & child.c
        curr.children = [cloned] + (child.children if child.children else [child])
        return
    had = bool(np.any(curr.u & child.u))
    curr.u = curr.u | child.u
    curr.c = curr.c & child.c
    curr.children.append(child)
    if had:
        _ref_balance(curr)


def _ref_balance(curr):
    m = len(curr.children)
    max_val, max_i, max_j = 0, 0, 0
    min_val = None
    for i in range(1, m):
        for j in range(i):
            v = _popcount_and(curr.children[i].c, curr.children[j].c)
            if v > max_val:
                max_val, max_i, max_j = v, i, j
            if min_val is None or v < min_val:
                min_val = v
    if min_val is None or max_val <= min_val:
        return
    one, two = curr.children[max_i], curr.children[max_j]
    if len(one.children) < len(two.children):
        adopter, adopted, rm = one, two, max_j
    else:
        adopter, adopted, rm = two, one, max_i
    del curr.children[rm]
    _ref_add_child(adopter, adopted)


def _ref_labels(root, n):
    labels = np.full(n, -1, np.int32)
    if root.protein is not None:
        labels[root.protein] = root.protein
        return labels
    for child in root.children:
        members, stack = [], [child]
        while stack:
            nd = stack.pop()
            if nd.protein is not None:
                members.append(nd.protein)
            stack.extend(nd.children)
        labels[np.asarray(members)] = min(members)
    return labels


def _random_bitset(rng, n, k, density):
    rows, cols = np.nonzero(rng.random((n, k)) < density)
    return pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=8, word_multiple=128,
    )


@pytest.mark.parametrize("density,seed", [(0.05, 0), (0.2, 1), (0.01, 2)])
def test_matches_direct_transcription(density, seed):
    rng = np.random.default_rng(seed)
    n, k = 80, 400
    bs = _random_bitset(rng, n, k, density)
    w64 = np.ascontiguousarray(bs.words[:n]).view(np.uint64)

    tree = build_tree(bs, n)
    root = _RefNode(w64[0], w64[0], 0)
    for i in range(1, n):
        _ref_add_child(root, _RefNode(w64[i], w64[i], i))
    assert np.array_equal(tree.labels(n), _ref_labels(root, n))


def test_structural_invariants():
    rng = np.random.default_rng(5)
    n, k = 60, 300
    bs = _random_bitset(rng, n, k, 0.08)
    tree = build_tree(bs, n)
    w64 = np.ascontiguousarray(bs.words[:n]).view(np.uint64)

    seen = []

    def check(node):
        if node.protein is not None:
            assert not node.children
            seen.append(node.protein)
            return node.u.copy(), node.u.copy()
        assert node.children
        u = None
        c = None
        for ch in node.children:
            cu, cc = check(ch)
            u = cu if u is None else (u | cu)
            c = cc if c is None else (c & cc)
        assert np.array_equal(node.u, u), "u != union of descendants"
        assert np.array_equal(node.c, c), "c != intersection of descendants"
        return u, c

    check(tree.root)
    assert sorted(seen) == list(range(n))
    labels = tree.labels(n)
    assert (labels >= 0).all()
    # labels are canonical minima
    for lbl in np.unique(labels):
        assert np.nonzero(labels == lbl)[0].min() == lbl


def test_identical_proteins_cluster_together():
    # four copies of two disjoint k-mer sets → exactly two clusters
    n, k = 8, 256
    rows = np.repeat(np.arange(8), 10).astype(np.int32)
    cols = np.concatenate([np.arange(10) + (i % 2) * 100 for i in range(8)]).astype(np.int32)
    bs = pack_bitsets(rows, cols, n, k, row_multiple=8, word_multiple=128)
    labels = build_tree(bs, n).labels(n)
    assert len(np.unique(labels)) == 2
    assert (labels[::2] == labels[0]).all()
    assert (labels[1::2] == labels[1]).all()


def test_native_and_numpy_sims_paths_agree(monkeypatch):
    """The fused native AND+popcount cache path and the numpy fallback
    must build identical trees (labels are a full structural probe)."""
    from uniprot_kmer_based_clustering_tpu.models import tree as treemod

    rng = np.random.default_rng(3)
    n, k = 120, 500
    bs = _random_bitset(rng, n, k, 0.08)
    lab_default = build_tree(bs, n).labels(n)
    monkeypatch.setattr(treemod, "_native_rows", None)
    lab_numpy = build_tree(bs, n).labels(n)
    assert np.array_equal(lab_default, lab_numpy)


def test_cluster_tree_accepts_uint32_rows():
    """ClusterTree is public API and BitsetMatrix rows are uint32 — the
    natural direct input. The native cache kernel's ABI is uint64 rows,
    so non-uint64 inputs must fall through to the numpy path instead of
    raising ctypes.ArgumentError mid-insertion (environment-dependent
    crash: only reproduced with the native lib built)."""
    from uniprot_kmer_based_clustering_tpu.models.tree import ClusterTree

    rng = np.random.default_rng(9)
    n, k = 40, 300
    bs = _random_bitset(rng, n, k, 0.1)
    rows32 = bs.words  # uint32, NOT viewed as uint64
    assert rows32.dtype == np.uint32
    t = ClusterTree(0, rows32[0])
    for i in range(1, n):
        t.add_protein(i, rows32[i])
    lab32 = t.labels(n)
    lab64 = build_tree(bs, n).labels(n)  # the uint64 fast path
    assert np.array_equal(lab32, lab64)


def test_single_protein_tree():
    bs = _random_bitset(np.random.default_rng(0), 1, 64, 0.2)
    t = build_tree(bs, 1)
    assert t.labels(1).tolist() == [0]


# --- adversarial tie semantics, pinned structure-by-structure ----------
#
# The reference's balance() (src/tree.rs:179-240) has three tie rules:
#   * max scan: strict ">" from (0,0,0) in (i asc from 1, j asc < i)
#     order — the FIRST strict maximum wins (src/tree.rs:207-209);
#   * merge gate: max > min, both strict (src/tree.rs:219) — all-equal
#     similarity vectors never merge;
#   * adopter: the child with FEWER children adopts; on equal counts the
#     EARLIER child (index j = max.2) adopts (src/tree.rs:227-236:
#     `if child_one_children_len < child_two_children_len` — ties fall
#     to the else branch, child_two adopts child_one).
# Labels alone cannot distinguish adopter direction (both give the same
# min-member label), so these tests pin the full ordered tree structure.


def _structure(node):
    """Canonical ordered shape: protein id at leaves, tuple at internals.
    Works for both models.tree._Node and the _RefNode transcription."""
    if node.protein is not None:
        return node.protein
    return tuple(_structure(c) for c in node.children)


def _bitset_from_sets(sets, k_bits):
    rows = np.concatenate(
        [np.full(len(s), i, np.int32) for i, s in enumerate(sets)]
    )
    cols = np.concatenate(
        [np.asarray(sorted(s), np.int32) for s in sets]
    )
    return pack_bitsets(rows, cols, len(sets), k_bits,
                        row_multiple=8, word_multiple=128)


def _both_trees(sets, k_bits=256):
    bs = _bitset_from_sets(sets, k_bits)
    n = len(sets)
    w64 = np.ascontiguousarray(bs.words[:n]).view(np.uint64)
    tree = build_tree(bs, n)
    root = _RefNode(w64[0], w64[0], 0)
    for i in range(1, n):
        _ref_add_child(root, _RefNode(w64[i], w64[i], i))
    return tree, root, n


def test_all_equal_intersections_never_merge():
    """All pairwise c-intersections equal → max == min → the strict
    merge gate (src/tree.rs:219) never fires: identical proteins stay
    FLAT under the root as separate children (reference semantics,
    however unintuitive)."""
    sets = [set(range(10))] * 4
    tree, root, n = _both_trees(sets)
    assert _structure(tree.root) == (0, 1, 2, 3)
    assert _structure(tree.root) == _structure(root)
    assert tree.labels(n).tolist() == [0, 1, 2, 3]


def test_zero_overlap_chain_never_balances():
    """Disjoint bitsets: the pre-update u∩child.u trigger
    (src/tree.rs:331-333,379-384) is empty on every insert — no balance
    call at all, the root accumulates a flat chain."""
    sets = [set(range(10 * i, 10 * i + 8)) for i in range(6)]
    tree, root, n = _both_trees(sets)
    assert _structure(tree.root) == tuple(range(6))
    assert _structure(tree.root) == _structure(root)
    assert tree.depth() == 2


def test_max_over_min_merges_first_max_tie_adopter():
    """AB share 10, AC/BC share 5: balance on [A,B,C] finds
    max=(10,i=1,j=0) (first strict max), min=5 → merge fires. Both
    children are leaves (0 == 0 children) so the tie rule makes the
    EARLIER child A the adopter (src/tree.rs:227-236 else-branch), which
    leaf-splits into (0, 1)."""
    sets = [set(range(10)), set(range(10)),
            set(range(5)) | set(range(10, 15))]
    tree, root, n = _both_trees(sets)
    assert _structure(tree.root) == ((0, 1), 2)
    assert _structure(tree.root) == _structure(root)
    assert tree.labels(n).tolist() == [0, 0, 2]


def test_fewer_children_adopter_and_internal_flattening():
    """Insert {P0,P1 twins}, a disjoint P2, twin P3, twin P4:

    * adding P3 balances [X=(P0,P1) merged earlier... ] — first the P0/P1
      twin pair merges under a tie (earlier adopts);
    * adding P4 then finds max at (P3, X) where X is internal (2
      children) and P3 a leaf (0) → P3, having FEWER children, adopts X
      (src/tree.rs:229-232 if-branch), and the leaf-case add_child
      FLATTENS the internal adoptee: P3's node becomes (3, 0, 1)
      (src/tree.rs:316-324).

    Final hand-derived structure: (2, (3, 0, 1), 4)."""
    ten = set(range(10))
    sets = [ten, ten, set(range(50, 55)), ten, ten]
    tree, root, n = _both_trees(sets)
    assert _structure(tree.root) == (2, (3, 0, 1), 4)
    assert _structure(tree.root) == _structure(root)
    # balance merges ONCE per insert: P4 stays a root child (label 4)
    assert tree.labels(n).tolist() == [0, 0, 2, 0, 4]


def test_more_children_means_other_adopts():
    """Mirror of the fewer-children rule: when the LATER child is the
    internal one, the earlier leaf adopts it. Order: twins P0,P1 (merge
    into X=(0,1) on P2's insert), then P3 a twin — balance pairs P3
    against X: P3 has 0 children < X's 2 → P3 adopts X again but now X
    sits at a LATER index than... the max scan found (i=later, j=earlier)
    so directionality is covered by index, not insertion time. This case
    pins the max-index bookkeeping: remove_idx must be the adoptee's
    index, and the adopter's cached sims must refresh after its c
    shrinks (models/tree.py _sims_refresh)."""
    ten = set(range(10))
    # P2 overlaps P0/P1 by 5 — enough to trigger balance, low enough to
    # lose the max scan
    sets = [ten, ten, set(range(5)) | set(range(20, 25)), ten, ten]
    tree, root, n = _both_trees(sets)
    assert _structure(tree.root) == _structure(root)
    lab = tree.labels(n)
    # all twins end under one root child
    assert lab[0] == lab[1] == lab[3] == lab[4] == 0


def test_seven_mer_bitset_tree_parity(toy_fasta):
    """k=7 path (src/tree.rs:96-105): the tree consumes the 7-mer
    rank-space bitset identically; parity vs the transcription on the
    real pipeline artifact."""
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    res = run_pipeline(
        toy_fasta,
        PipelineConfig(k=7, tile=16, strip=32, 
                       engine="xla", threshold=2, cluster="tree"),
    )
    n = res.table.n
    bs = res.bitset
    w64 = np.ascontiguousarray(bs.words[:n]).view(np.uint64)
    root = _RefNode(w64[0], w64[0], 0)
    for i in range(1, n):
        _ref_add_child(root, _RefNode(w64[i], w64[i], i))
    assert np.array_equal(res.cluster_labels, _ref_labels(root, n))
    t = build_tree(bs, n)
    assert _structure(t.root) == _structure(root)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_structure_parity(seed):
    """Differential fuzz vs the transcription at adversarial densities:
    heavy overlap forces adopter-refresh cascades and recursive balance
    chains (the adopter's add_child re-balances its own children,
    src/tree.rs:232-239 → 179). Structure equality (not just labels)
    pins every adoption decision."""
    rng = np.random.default_rng(seed)
    n, k = 150, 300
    density = [0.02, 0.08, 0.3][seed % 3]
    bs = _random_bitset(rng, n, k, density)
    w64 = np.ascontiguousarray(bs.words[:n]).view(np.uint64)
    tree = build_tree(bs, n)
    root = _RefNode(w64[0], w64[0], 0)
    for i in range(1, n):
        _ref_add_child(root, _RefNode(w64[i], w64[i], i))
    assert _structure(tree.root) == _structure(root)
    assert np.array_equal(tree.labels(n), _ref_labels(root, n))
