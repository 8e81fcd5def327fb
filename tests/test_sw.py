"""Smith-Waterman aligner: textbook-DP oracle vs host vs device kernel."""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.align.sw_host import (
    GAP_EXTEND,
    GAP_OPEN,
    sw_align_host,
)
from uniprot_kmer_based_clustering_tpu.align.sw_device import (
    sw_ends_and_starts_device,
    sw_scores_device,
)
from uniprot_kmer_based_clustering_tpu.utils.blosum import blosum62_matrix

B62 = blosum62_matrix().astype(np.int64)
NEG = -(10**6)


def sw_textbook(q, s):
    """Per-cell Gotoh DP, no vectorization tricks — the independent oracle."""
    lq, ls = len(q), len(s)
    h = np.zeros((lq + 1, ls + 1), np.int64)
    e = np.full((lq + 1, ls + 1), NEG, np.int64)
    f = np.full((lq + 1, ls + 1), NEG, np.int64)
    best = 0
    for i in range(1, lq + 1):
        for j in range(1, ls + 1):
            e[i][j] = max(e[i][j - 1] - GAP_EXTEND, h[i][j - 1] - GAP_OPEN)
            f[i][j] = max(f[i - 1][j] - GAP_EXTEND, h[i - 1][j] - GAP_OPEN)
            h[i][j] = max(
                0,
                h[i - 1][j - 1] + B62[q[i - 1], s[j - 1]],
                e[i][j],
                f[i][j],
            )
            best = max(best, h[i][j])
    return int(best)


def _rand_pairs(rng, n, lo=5, hi=48):
    out = []
    for _ in range(n):
        lq = int(rng.integers(lo, hi))
        ls = int(rng.integers(lo, hi))
        out.append(
            (
                rng.integers(0, 21, lq).astype(np.int32),
                rng.integers(0, 21, ls).astype(np.int32),
            )
        )
    return out


def test_host_matches_textbook_scores():
    rng = np.random.default_rng(7)
    for q, s in _rand_pairs(rng, 30):
        assert sw_align_host(q, s).score == sw_textbook(q, s)


def test_host_self_alignment():
    rng = np.random.default_rng(8)
    q = rng.integers(0, 20, 30).astype(np.int32)
    a = sw_align_host(q, q)
    assert a.score == int(B62[q, q].sum())
    assert a.pident == 100.0
    assert (a.q_start, a.q_end) == (1, 30)
    assert (a.s_start, a.s_end) == (1, 30)
    assert a.length == 30 and a.gaps == 0


def test_host_affine_gap():
    rng = np.random.default_rng(9)
    q = rng.integers(0, 20, 40).astype(np.int32)
    s = np.concatenate([q[:20], rng.integers(0, 20, 3), q[20:]]).astype(
        np.int32
    )
    a = sw_align_host(q, s)
    full = int(B62[q, q].sum())
    # either bridge the 3-residue insertion (one affine gap) or take the
    # better flank — bridging should win for a 40-residue match
    assert a.score >= full - (GAP_OPEN + 2 * GAP_EXTEND)
    if a.gaps:
        assert a.gaps == 3
        assert a.length == 43


def test_host_traceback_consistency():
    """length/identities/coordinates are mutually consistent."""
    rng = np.random.default_rng(10)
    for q, s in _rand_pairs(rng, 20, lo=10, hi=60):
        a = sw_align_host(q, s)
        if a.score == 0:
            continue
        assert 1 <= a.q_start <= a.q_end <= len(q)
        assert 1 <= a.s_start <= a.s_end <= len(s)
        span_q = a.q_end - a.q_start + 1
        span_s = a.s_end - a.s_start + 1
        assert a.length >= max(span_q, span_s)
        assert a.length - a.gaps <= min(span_q, span_s) + a.gaps
        assert 0 <= a.identities <= min(span_q, span_s)


def test_device_matches_host_scores():
    rng = np.random.default_rng(11)
    pairs = _rand_pairs(rng, 24, lo=5, hi=64)
    b = len(pairs)
    lq = max(len(q) for q, _ in pairs)
    ls = max(len(s) for _, s in pairs)
    q_idx = np.zeros((b, lq), np.int32)
    s_idx = np.zeros((b, ls), np.int32)
    q_len = np.zeros(b, np.int64)
    s_len = np.zeros(b, np.int64)
    for r, (q, s) in enumerate(pairs):
        q_idx[r, : len(q)] = q
        s_idx[r, : len(s)] = s
        q_len[r], s_len[r] = len(q), len(s)
    score, qe, se = sw_scores_device(q_idx, q_len, s_idx, s_len)
    for r, (q, s) in enumerate(pairs):
        assert score[r] == sw_align_host(q, s).score, r


def test_device_ends_bound_an_optimal_window():
    """The (start, end) windows from the two-pass device kernel contain a
    local alignment of the full score."""
    rng = np.random.default_rng(12)
    pairs = _rand_pairs(rng, 12, lo=12, hi=48)
    b = len(pairs)
    lq = max(len(q) for q, _ in pairs)
    ls = max(len(s) for _, s in pairs)
    q_idx = np.zeros((b, lq), np.int32)
    s_idx = np.zeros((b, ls), np.int32)
    q_len = np.zeros(b, np.int64)
    s_len = np.zeros(b, np.int64)
    for r, (q, s) in enumerate(pairs):
        q_idx[r, : len(q)] = q
        s_idx[r, : len(s)] = s
        q_len[r], s_len[r] = len(q), len(s)
    score, qs, qe, ss, se = sw_ends_and_starts_device(
        q_idx, q_len, s_idx, s_len
    )
    for r, (q, s) in enumerate(pairs):
        if score[r] == 0:
            continue
        w = sw_align_host(
            q[qs[r] - 1 : qe[r]], s[ss[r] - 1 : se[r]]
        )
        assert w.score == score[r], r


def test_bitscore_evalue_monotone():
    from uniprot_kmer_based_clustering_tpu.align.sw_host import (
        LocalAlignment,
    )

    a = LocalAlignment(100, 1, 10, 1, 10, 10, 10, 0)
    b = LocalAlignment(200, 1, 10, 1, 10, 10, 10, 0)
    assert b.bitscore() > a.bitscore()
    assert b.evalue(300, 300) < a.evalue(300, 300)
    assert a.evalue(300, 300) > 0


def test_cli_align_sw(toy_fasta, tmp_path):
    """--align sw writes an outfmt-6-compatible blastp_output.tsv."""
    from uniprot_kmer_based_clustering_tpu.align.diamond import TSV_HEADER
    from uniprot_kmer_based_clustering_tpu.cli import main

    out = str(tmp_path / "out_sw")
    rc = main([
        "run", toy_fasta, "--engine", "xla", "--threshold", "2",
        "--align", "sw", "--out", out, "--cpu",
    ])
    assert rc == 0
    import os

    text = open(os.path.join(out, "blastp_output.tsv")).read()
    rows = text.strip().splitlines()
    assert rows[0] + "\n" == TSV_HEADER
    prows = open(os.path.join(out, "pairs.tsv")).read().strip().splitlines()
    assert len(rows) - 1 == len(prows) - 1  # one alignment per pair
    for r in rows[1:]:
        cols = r.split("\t")
        assert len(cols) == 12
        qlen, slen = int(cols[1]), int(cols[3])
        qs, qe, ss, se = map(int, cols[4:8])
        assert 1 <= qs <= qe <= qlen
        assert 1 <= ss <= se <= slen
        assert 0.0 <= float(cols[9]) <= 100.0
        assert float(cols[11]) > 0


def test_align_pairs_sw_windowed_equals_full(toy_fasta, tmp_path):
    """Window-bounded traceback (device ends) == full host DP output."""
    import numpy as np

    from uniprot_kmer_based_clustering_tpu import cluster_fasta
    from uniprot_kmer_based_clustering_tpu.align import align_pairs_sw

    res = cluster_fasta(
        toy_fasta, engine="xla", threshold=2, tile=16, strip=32,
        
    )
    w = str(tmp_path / "w.tsv")
    f = str(tmp_path / "f.tsv")
    align_pairs_sw(res.table, res.pairwise.pairs, w)
    align_pairs_sw(res.table, res.pairwise.pairs, f, device_scores=False)
    assert open(w).read() == open(f).read()


def test_align_pairs_sw_small_batches_keep_order(toy_fasta, tmp_path):
    """Bucket-sorted batching (one compiled shape per length bucket) must
    still write lines in the input pair order, including across multiple
    partially-filled batches."""
    from uniprot_kmer_based_clustering_tpu import cluster_fasta
    from uniprot_kmer_based_clustering_tpu.align import align_pairs_sw

    res = cluster_fasta(
        toy_fasta, engine="xla", threshold=2, tile=16, strip=32,
        
    )
    assert len(res.pairwise.pairs) > 3
    one = str(tmp_path / "one.tsv")
    many = str(tmp_path / "many.tsv")
    align_pairs_sw(res.table, res.pairwise.pairs, one, device_scores=False)
    align_pairs_sw(
        res.table, res.pairwise.pairs, many, batch=2, device_scores=False
    )
    assert open(one).read() == open(many).read()


def test_align_pairs_sw_zero_score_pair_emits_no_row(tmp_path):
    """A pair with no local alignment at all (empty sequence) must emit
    NO TSV row — the Karlin-Altschul formula would otherwise stamp it
    with e-value 0.0, the most significant value (diamond emits no row
    either)."""
    from uniprot_kmer_based_clustering_tpu.align import align_pairs_sw
    from uniprot_kmer_based_clustering_tpu.io import read_fasta

    fa = tmp_path / "z.fasta"
    fa.write_text(
        ">E0|F|U|beta_lactam|g0\n"
        ">P1|F|U|bacitracin|g1\nMKTAYIAKQR\n"
        ">P2|F|U|MLS|g2\nMKTAYIAKQR\n"
    )
    table = read_fasta(str(fa))
    out = str(tmp_path / "z.tsv")
    pairs = np.array([[0, 1, 1], [1, 2, 5]], np.int64)
    align_pairs_sw(table, pairs, out, device_scores=False)
    lines = open(out).read().splitlines()
    # header + only the real (1,2) alignment; the empty-vs-P1 pair is gone
    assert len(lines) == 2
    assert "E0|" not in lines[1]
    assert float(lines[1].split("\t")[10]) < 1  # a genuinely strong hit


def test_align_pairs_sw_empty(toy_fasta, tmp_path):
    """Empty pair list writes a header-only TSV (regression: IndexError
    from indexing a 1-D empty array)."""
    from uniprot_kmer_based_clustering_tpu.align import align_pairs_sw
    from uniprot_kmer_based_clustering_tpu.io import read_fasta

    out = str(tmp_path / "empty.tsv")
    align_pairs_sw(read_fasta(toy_fasta), [], out, device_scores=False)
    lines = open(out).read().splitlines()
    assert len(lines) == 1 and lines[0].startswith("qseqid")
