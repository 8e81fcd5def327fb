"""Native C++ runtime vs numpy fallbacks: byte-identical outputs."""

import os
from pathlib import Path

import numpy as np
import pytest

_REPO = str(Path(__file__).resolve().parent.parent)

from uniprot_kmer_based_clustering_tpu.io import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_fasta_parse_matches_python(toy_fasta):
    from uniprot_kmer_based_clustering_tpu.io.fasta import parse_fasta_bytes

    with open(toy_fasta, "rb") as f:
        data = f.read()
    py_ids, py_seq, py_off = parse_fasta_bytes(data)
    nat = native.parse_fasta(toy_fasta)
    assert nat is not None
    ids, seq, off = nat
    assert ids == py_ids
    assert np.array_equal(seq, py_seq)
    assert np.array_equal(off, py_off)


def test_read_fasta_gzipped(toy_fasta, tmp_path):
    """Gzipped corpora parse identically (magic-sniffed — no .gz
    extension needed; UniProt ships gzipped)."""
    import gzip

    from uniprot_kmer_based_clustering_tpu.io import read_fasta

    gz = tmp_path / "toy.fasta.gz"
    with open(toy_fasta, "rb") as f:
        gz.write_bytes(gzip.compress(f.read()))
    plain = read_fasta(toy_fasta)
    zipped = read_fasta(str(gz))
    assert zipped.ids == plain.ids
    assert np.array_equal(zipped.seq_buf, plain.seq_buf)
    assert np.array_equal(zipped.offsets, plain.offsets)
    assert np.array_equal(zipped.amr_class_ids, plain.amr_class_ids)


def test_fasta_parse_edge_cases(tmp_path):
    from uniprot_kmer_based_clustering_tpu.io.fasta import parse_fasta_bytes

    # CRLF, multi-line sequences, trailing whitespace in ids, blank lines
    data = (
        b">id1|a|b|c extra words\r\n"
        b"CSTAG\r\nPDEQN\r\n"
        b"\n"
        b">id2|x|y|z\n"
        b"WWWWW\n"
    )
    p = tmp_path / "edge.fasta"
    p.write_bytes(data)
    py_ids, py_seq, py_off = parse_fasta_bytes(data)
    ids, seq, off = native.parse_fasta(str(p))
    assert ids == py_ids == ["id1|a|b|c", "id2|x|y|z"]
    assert np.array_equal(seq, py_seq)
    assert np.array_equal(off, py_off)


def test_pack_bits_matches_numpy(rng):
    from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets

    n, k = 50, 700
    rows, cols = np.nonzero(rng.random((n, k)) < 0.05)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    words = native.pack_bits(
        rows.astype(np.int32), cols.astype(np.int32), bs.n_pad, bs.w_pad
    )
    assert np.array_equal(words, bs.words)


def test_and_popcnt_rows_matches_numpy(rng):
    fn = native.and_popcnt_rows_fn()
    assert fn is not None
    for m, w in [(1, 1), (3, 7), (17, 16), (33, 23), (200, 57)]:
        mat = rng.integers(0, 2**63, (m, w), dtype=np.uint64)
        vec = rng.integers(0, 2**63, w, dtype=np.uint64)
        out = np.empty(m, np.int64)
        fn(mat, m, vec, out)
        ref = np.bitwise_count(mat & vec).sum(axis=1, dtype=np.int64)
        assert np.array_equal(out, ref), (m, w)
        # prefix-only call leaves the tail untouched
        if m > 2:
            out2 = np.full(m, -1, np.int64)
            fn(mat, m - 2, vec, out2)
            assert np.array_equal(out2[: m - 2], ref[: m - 2])
            assert (out2[m - 2 :] == -1).all()


def test_popcount_sweep_matches_xla(rng):
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
    from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        extract_pairs,
    )

    n, k = 120, 800
    rows, cols = np.nonzero(rng.random((n, k)) < 0.05)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=8, word_multiple=128,
    )
    classes = np.full(bs.n_pad, -1, np.int32)
    classes[:n] = rng.integers(0, 3, n)
    rsx, thx, tx = sweep_xla(
        jnp.asarray(bs.words), jnp.asarray(classes), n, 3, tile=8
    )
    px = extract_pairs(jnp.asarray(bs.words), classes, thx, tx, n=n, threshold=3)

    out = native.popcount_sweep(bs.words, n, classes, 3)
    assert out is not None
    row_stats, pairs = out
    assert np.array_equal(row_stats.sum(axis=0), rsx.sum(axis=0)[:8])
    assert np.array_equal(pairs, px)

    # the sparse Gustavson sweep must be output-identical to the dense
    # one — same row_stats (incl. per-row maxes), same pair list. The
    # incidence lists must be sorted by (protein, rank): np.nonzero's
    # row-major order provides exactly that.
    sp = native.sparse_sweep(
        rows.astype(np.int32), cols.astype(np.int32), n, k, classes, 3
    )
    assert sp is not None
    assert np.array_equal(sp[0], row_stats)
    assert np.array_equal(sp[1], pairs)

    # pair-buffer overflow retry: a tiny cap must still return the full
    # exact result (second pass with the exact size)
    sp_small = native.sparse_sweep(
        rows.astype(np.int32), cols.astype(np.int32), n, k, classes, 3,
        pairs_cap=4,
    )
    assert np.array_equal(sp_small[0], row_stats)
    assert np.array_equal(sp_small[1], pairs)
    dn_small = native.popcount_sweep(bs.words, n, classes, 3, pairs_cap=4)
    assert np.array_equal(dn_small[0], row_stats)
    assert np.array_equal(dn_small[1], pairs)

    # include_same surfaces class-equal pairs in both engines identically
    sp_all = native.sparse_sweep(
        rows.astype(np.int32), cols.astype(np.int32), n, k, classes, 3,
        include_same=True,
    )
    dn_all = native.popcount_sweep(
        bs.words, n, classes, 3, include_same=True
    )
    assert np.array_equal(sp_all[1], dn_all[1])
    assert sp_all[1].shape[0] >= pairs.shape[0]


def test_native_index_matches_numpy(toy_fasta):
    from uniprot_kmer_based_clustering_tpu.io import native
    from uniprot_kmer_based_clustering_tpu.io.fasta import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers.encode import encode_kmers
    from uniprot_kmer_based_clustering_tpu.kmers.index import build_index

    if not native.available():
        pytest.skip("native library unavailable")
    table = read_fasta(toy_fasta)
    for k in (5, 7):
        codes, koff = encode_kmers(table.seq_buf, table.offsets, k)
        a = build_index(codes, koff, k, engine="native")
        b = build_index(codes, koff, k, engine="numpy")
        assert np.array_equal(a.codes, b.codes), k
        assert np.array_equal(a.doc_freq, b.doc_freq), k
        assert np.array_equal(a.repeated_codes, b.repeated_codes), k
        assert np.array_equal(a.incidence_protein, b.incidence_protein), k
        assert np.array_equal(a.incidence_rank, b.incidence_rank), k
        assert np.array_equal(a.hash_doc_freq, b.hash_doc_freq), k


def test_parsers_agree_on_messy_fasta(tmp_path):
    """Wrapped sequences, CRLF, blank lines, no trailing newline: the
    native and numpy parsers produce identical tables."""
    import numpy as np

    from uniprot_kmer_based_clustering_tpu.io import native
    from uniprot_kmer_based_clustering_tpu.io.fasta import parse_fasta_bytes

    content = (
        ">P1|F|U|beta_lactam|g1\r\n"
        "MKT\r\nLLV\r\n"
        "\r\n"
        ">P2|F|U|MLS|g2\n"
        "ACDEFGHIK\n"
        ">P3|F|U|bacitracin|g3\nMKVT"
    )
    p = tmp_path / "messy.fasta"
    p.write_bytes(content.encode())
    got_native = native.parse_fasta(str(p))
    if got_native is None:
        import pytest

        pytest.skip("native library unavailable")
    ids_n, buf_n, off_n = got_native
    ids_h, buf_h, off_h = parse_fasta_bytes(p.read_bytes())
    assert ids_n == ids_h
    assert np.array_equal(buf_n, buf_h)
    assert np.array_equal(off_n, off_h)
    assert bytes(buf_h[off_h[0]:off_h[1]]) == b"MKTLLV"
    assert bytes(buf_h[off_h[2]:off_h[3]]) == b"MKVT"


def test_parsers_reject_empty_header_id(tmp_path):
    """A header with no id token is a loud ValueError in BOTH parsers
    (not an IndexError, not a silent empty id)."""
    import pytest

    from uniprot_kmer_based_clustering_tpu.io.fasta import parse_fasta_bytes

    for bad in (b">\nMKT\n", b">   \nMKT\n"):
        with pytest.raises(ValueError):
            parse_fasta_bytes(bad)
        p = tmp_path / "bad.fasta"
        p.write_bytes(bad)
        with pytest.raises(ValueError):
            native.parse_fasta(str(p))


def test_parsers_agree_on_padded_header(tmp_path):
    """Leading whitespace after '>' is skipped before the id token in
    both parsers (io/fasta.py split(None) semantics)."""
    from uniprot_kmer_based_clustering_tpu.io.fasta import parse_fasta_bytes

    data = b"> id1|a|b|c desc\nMKTLL\n>\tid2|x|y|z\nWWWWW\n"
    p = tmp_path / "pad.fasta"
    p.write_bytes(data)
    py_ids, py_seq, py_off = parse_fasta_bytes(data)
    ids, seq, off = native.parse_fasta(str(p))
    assert ids == py_ids == ["id1|a|b|c", "id2|x|y|z"]
    assert np.array_equal(seq, py_seq)
    assert np.array_equal(off, py_off)


def test_parsers_agree_on_exotic_whitespace(tmp_path):
    """Multiple trailing CRs and non-space whitespace in headers: the
    native parser must match numpy's rstrip-all-\\r / split(None)
    semantics (a stray \\r in the id shifts the AMR-class field)."""
    from uniprot_kmer_based_clustering_tpu.io.fasta import parse_fasta_bytes

    data = (
        b">sp|A|B|cls\r\r\nMSEQ\r\r\n"
        b">sp|C|D|cls2\x0cjunk\nQQQQ\n"
        b">sp|E|F|cls3\x0bmore desc\nWWWW\n"
    )
    p = tmp_path / "exotic.fasta"
    p.write_bytes(data)
    py_ids, py_seq, py_off = parse_fasta_bytes(data)
    ids, seq, off = native.parse_fasta(str(p))
    assert ids == py_ids == ["sp|A|B|cls", "sp|C|D|cls2", "sp|E|F|cls3"]
    assert np.array_equal(seq, py_seq)
    assert seq.tobytes() == b"MSEQQQQQWWWW"
    assert np.array_equal(off, py_off)


def test_parser_fuzz_parity(tmp_path):
    """Randomized FASTA fuzz: the native and numpy parsers must agree on
    ids/sequences/offsets (or both reject) for arbitrary mixtures of
    CRLF, blank lines, wrapped sequences, descriptions, and whitespace."""
    from uniprot_kmer_based_clustering_tpu.io.fasta import parse_fasta_bytes

    rng = np.random.default_rng(123)
    aas = "CSTAGPDEQNHRKMILVWYF"
    ws = [" ", "\t", "\x0b", "\x0c"]
    for trial in range(30):
        lines = []
        for r in range(int(rng.integers(1, 6))):
            ident = "P%d|F|U|c%d|g" % (trial, r)
            desc = ""
            if rng.random() < 0.5:
                desc = ws[int(rng.integers(0, 4))] + "some desc"
            lead = ws[int(rng.integers(0, 4))] if rng.random() < 0.3 else ""
            cr = "\r" * int(rng.integers(0, 3))
            lines.append(">" + lead + ident + desc + cr)
            seq = "".join(
                aas[i] for i in rng.integers(0, 20, int(rng.integers(5, 60)))
            )
            # wrap into chunks, sprinkle blank lines and CRs
            pos = 0
            while pos < len(seq):
                w = int(rng.integers(3, 30))
                lines.append(seq[pos : pos + w] + "\r" * int(rng.integers(0, 2)))
                pos += w
                if rng.random() < 0.2:
                    lines.append("")
        data = "\n".join(lines)
        if rng.random() < 0.5:
            data += "\n"
        data = data.encode()
        p = tmp_path / f"fuzz{trial}.fasta"
        p.write_bytes(data)

        try:
            expected = parse_fasta_bytes(data)
            failed = None
        except ValueError as e:
            expected, failed = None, e
        if failed is not None:
            with pytest.raises(ValueError):
                native.parse_fasta(str(p))
            continue
        ids, seq_buf, off = native.parse_fasta(str(p))
        assert ids == expected[0], trial
        assert np.array_equal(seq_buf, expected[1]), trial
        assert np.array_equal(off, expected[2]), trial


def test_sparse_sweep_fuzz_parity(rng):
    """Randomized shapes/densities/class layouts: the sparse Gustavson
    sweep and the dense popcount sweep must agree exactly — row_stats
    AND pair lists — including degenerate inputs (empty incidence,
    single protein, all-same-class, threshold 0)."""
    from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets

    cases = [
        (1, 40, 0.2, 1, 0),
        (2, 40, 0.0, 3, 1),     # no incidences at all
        (17, 130, 0.3, 1, 0),   # all same class, threshold 0
        (33, 513, 0.08, 4, 2),
        (64, 64, 0.5, 2, 5),    # dense bitset, high counts
        (120, 2000, 0.02, 15, 3),
    ]
    for n, k, dens, n_cls, thr in cases:
        rows, cols = np.nonzero(rng.random((n, k)) < dens)
        rows = rows.astype(np.int32)
        cols = cols.astype(np.int32)
        bs = pack_bitsets(rows, cols, n, k, row_multiple=8,
                          word_multiple=128)
        classes = rng.integers(0, n_cls, n).astype(np.int32)
        for include_same in (False, True):
            dn = native.popcount_sweep(
                bs.words, n, classes, thr, include_same=include_same
            )
            sp = native.sparse_sweep(
                rows, cols, n, k, classes, thr,
                include_same=include_same,
            )
            assert np.array_equal(sp[0], dn[0]), (n, k, dens, include_same)
            assert np.array_equal(sp[1], dn[1]), (n, k, dens, include_same)
            # forced multithreading exercises the atomic row-claim and
            # pair-slot paths (this box's cpu_count=1 would otherwise
            # never run them); results must stay bit-identical
            for fn, args in (
                (native.popcount_sweep, (bs.words, n, classes, thr)),
                (native.sparse_sweep, (rows, cols, n, k, classes, thr)),
            ):
                mt = fn(*args, include_same=include_same, n_threads=4)
                assert np.array_equal(mt[0], dn[0]), (n, k, include_same)
                assert np.array_equal(mt[1], dn[1]), (n, k, include_same)


def test_sparse_sweep_weighted_matches_mxu(toy_fasta):
    """BLOSUM-weighted native sparse sweep == weighted matmul engine:
    identical PairwiseResult counters and pair lists."""
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.io.fasta import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
    from uniprot_kmer_based_clustering_tpu.kmers.encode import encode_kmers
    from uniprot_kmer_based_clustering_tpu.kmers.index import build_index
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        pairwise_similarity,
    )
    from uniprot_kmer_based_clustering_tpu.utils.blosum import (
        rank_weights_int8,
    )

    table = read_fasta(toy_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    index = build_index(codes, koff, 5)
    bs = pack_bitsets(
        index.incidence_protein, index.incidence_rank,
        table.n, index.n_repeated,
    )
    weights = rank_weights_int8(index.repeated_codes, 5, bs.w_pad * 32)
    for cross_only in (True, False):
        cfg_m = PipelineConfig(
            engine="mxu", weighting="blosum62", cross_amr_only=cross_only
        )
        cfg_n = PipelineConfig(
            engine="native", weighting="blosum62",
            cross_amr_only=cross_only,
        )
        a = pairwise_similarity(
            bs, table.amr_class_ids, cfg_m, weights=weights
        )
        b = pairwise_similarity(
            bs, table.amr_class_ids, cfg_n, weights=weights, index=index
        )
        assert a.parity_counters() == b.parity_counters(), cross_only
        assert np.array_equal(a.pairs, b.pairs), cross_only


def test_native_encode_matches_numpy(toy_fasta, rng):
    """Native rolling encoder == numpy window encoder: real FASTA plus
    randomized buffers with unknown bytes, short/empty proteins."""
    from uniprot_kmer_based_clustering_tpu.io.fasta import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers.encode import encode_kmers

    table = read_fasta(toy_fasta)
    for k in (5, 7):
        a = native.encode_kmers(table.seq_buf, table.offsets, k)
        c, o = encode_kmers(
            table.seq_buf, table.offsets, k, engine="numpy"
        )
        assert np.array_equal(a[0], c), k
        assert np.array_equal(a[1], o), k

    # fuzz: arbitrary bytes (catch-all routing), lengths 0..k+3
    for trial in range(20):
        lens = rng.integers(0, 12, rng.integers(1, 9))
        buf = rng.integers(0, 256, int(lens.sum())).astype(np.uint8)
        off = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        for k in (5, 7):
            a = native.encode_kmers(buf, off, k)
            c, o = encode_kmers(buf, off, k, engine="numpy")
            assert np.array_equal(a[0], c), (trial, k)
            assert np.array_equal(a[1], o), (trial, k)


def test_loader_degrades_without_toolchain(toy_fasta, tmp_path):
    """A broken native tree (stale lib with wrong ABI, unbuildable
    source) must degrade to the numpy/xla fallbacks — available() is
    False and the pipeline still answers exactly. Subprocess: the
    loader's module state is process-global."""
    import subprocess
    import sys
    import textwrap

    bad = tmp_path / "native"
    bad.mkdir()
    # a Makefile that always fails + a fake stale library that cannot
    # even load: the loader must not crash, just give up
    (bad / "Makefile").write_text("all:\n\tfalse\n")
    (bad / "ukc_native.cpp").write_text("intentionally broken {")
    build = bad / "build"
    build.mkdir()
    (build / "libukc_native.so").write_bytes(b"\x7fELFgarbage")

    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {repr(str(_REPO))})
        import jax
        jax.config.update("jax_platforms", "cpu")
        from uniprot_kmer_based_clustering_tpu.io import native
        assert native.available() is False
        assert native.parse_fasta({repr(toy_fasta)}) is None
        import numpy as np
        buf = np.frombuffer(b"ACDEFGH", np.uint8)
        off = np.array([0, buf.shape[0]], np.int64)
        assert native.encode_kmers(buf, off, 5) is None
        from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
        from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline
        res = run_pipeline({repr(toy_fasta)}, PipelineConfig(cluster="none"))
        print("OK", res.parity_report()["pairs_over_threshold"])
    """)
    env = dict(os.environ, UKC_NATIVE_DIR=str(bad), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", script], env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("OK")


def test_pairwise_native_dense_branch_matches_sparse(toy_fasta):
    """pairwise_similarity(engine='native') without an index (the
    device-built-index situation) takes the dense AVX sweep and must
    equal the sparse branch taken when the index is supplied."""
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.io.fasta import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
    from uniprot_kmer_based_clustering_tpu.kmers.encode import encode_kmers
    from uniprot_kmer_based_clustering_tpu.kmers.index import build_index
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        pairwise_similarity,
    )

    table = read_fasta(toy_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    index = build_index(codes, koff, 5)
    bs = pack_bitsets(
        index.incidence_protein, index.incidence_rank,
        table.n, index.n_repeated,
    )
    cfg = PipelineConfig(engine="native", cluster="none", threshold=1)
    dense = pairwise_similarity(bs, table.amr_class_ids, cfg)
    sparse = pairwise_similarity(
        bs, table.amr_class_ids, cfg, index=index
    )
    assert dense.parity_counters() == sparse.parity_counters()
    assert np.array_equal(dense.pairs, sparse.pairs)


@pytest.mark.skipif(
    not os.path.exists("/root/reference/uniprot_arg.fasta"),
    reason="bundled dataset missing",
)
def test_all_pairs_golden_constants_full_dataset():
    """Dataset-level golden counters for --all-pairs mode (AMR gate off:
    the reference skipping remove_uninteresting_edges,
    src/graph/mod.rs:549-697). Consistency anchor: cross+same weighted
    edges must sum to the 258,621,291 multigraph edges of BASELINE.md —
    every shared-k-mer occurrence lands in exactly one population."""
    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        PairwiseResult,
    )

    table = read_fasta("/root/reference/uniprot_arg.fasta")
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)
    classes = np.asarray(table.amr_class_ids, np.int32)
    rs, pairs = native.sparse_sweep(
        idx.incidence_protein, idx.incidence_rank, table.n,
        idx.n_repeated, classes, 10, include_same=True,
    )
    res = PairwiseResult.from_row_stats(rs, pairs, cross_amr_only=False)
    # cross lanes: the BASELINE.md goldens
    assert (res.cross_weight, res.cross_pairs, res.cross_over,
            res.cross_max) == (5_300_233, 4_350_628, 465, 567)
    # same-class lanes (computed once, 2026-08-18, native+scipy agree)
    assert (res.same_weight, res.same_pairs, res.same_over,
            res.same_max) == (253_321_058, 10_755_128, 5_968_832, 1_039)
    # conservation: the two populations partition the multigraph
    assert res.cross_weight + res.same_weight == 258_621_291
    # mode-aware counters track the surfaced pair list
    rep = res.parity_counters()
    assert rep["pairs_over_threshold"] == 465 + 5_968_832
    assert rep["pairs_over_threshold"] == pairs.shape[0]
    assert rep["max_shared_kmers"] == 1_039
