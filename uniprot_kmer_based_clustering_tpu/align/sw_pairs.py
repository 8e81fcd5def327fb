"""On-device alignment of surviving pairs: blastp_output.tsv without
diamond.

Replaces the reference's per-pair subprocess fan-out
(``Graph::align_and_output_pairs``, src/graph/mod.rs:195-319) with one
batched device program: every pair's Smith-Waterman score + end
coordinates compute on-chip (align/sw_device.py), then the host
traceback oracle (align/sw_host.py) fills the remaining outfmt-6
fields for the pairs being written (465 on the bundled dataset).

Column-compatible with the reference's diamond output
(qseqid qlen sseqid slen qstart qend sstart send length pident evalue
bitscore); values differ from diamond's heuristic seed-and-extend
results — this is the exact-DP optimum (diamond may report several HSPs
per pair; this reports the optimal one). E-values use the pairwise
Karlin-Altschul search space m·n rather than diamond's database-wide
effective lengths.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu.align.diamond import TSV_HEADER
from uniprot_kmer_based_clustering_tpu.align.sw_host import (
    LocalAlignment,
    sw_align_host,
)
from uniprot_kmer_based_clustering_tpu.align.sw_device import (
    sw_ends_and_starts_device,
)
from uniprot_kmer_based_clustering_tpu.io.fasta import ProteinTable
from uniprot_kmer_based_clustering_tpu.kmers.encode import (
    residues_to_indices,
)


def _pair_batches(table: ProteinTable, pairs, batch: int, res):
    """Yield (rows, q_idx, q_len, s_idx, s_len, nv) padded batches.

    Reference vertex order: ref = vertices_key[0] (our lower index i,
    the diamond path's makedb side = subject), query = j.

    Shapes are BUCKETED: pairs are processed sorted by their padded
    (Lq, Ls) bucket and every batch pads B to `batch` and lengths to
    128-multiples, so the device kernel compiles one shape per occupied
    bucket (≤ ~(maxlen/128)² total) instead of one per batch — each
    unique shape is one more compile. `nv`
    is the number of real rows (the rest repeat row 0 and are dropped).
    """
    lengths = table.lengths.astype(np.int64)
    offsets = table.offsets
    lqb = -(-np.maximum(lengths[pairs[:, 1]], 1) // 128) * 128
    lsb = -(-np.maximum(lengths[pairs[:, 0]], 1) // 128) * 128
    order = np.lexsort((lsb, lqb))
    for lo in range(0, len(order), batch):
        sel = order[lo : lo + batch]
        rows = pairs[sel]
        nv = len(rows)
        qi = rows[:, 1].astype(np.int64)  # query = j
        si = rows[:, 0].astype(np.int64)  # subject = i
        lq = int(lqb[sel].max())
        ls = int(lsb[sel].max())
        q_idx = np.zeros((batch, lq), np.int32)
        s_idx = np.zeros((batch, ls), np.int32)
        q_len = np.zeros(batch, np.int64)
        s_len = np.zeros(batch, np.int64)
        for r in range(nv):
            a, b = offsets[qi[r]], offsets[qi[r] + 1]
            q_idx[r, : b - a] = res[a:b]
            a, b = offsets[si[r]], offsets[si[r] + 1]
            s_idx[r, : b - a] = res[a:b]
        q_len[:nv] = lengths[qi]
        s_len[:nv] = lengths[si]
        if nv < batch:  # pad slots repeat the first row (valid inputs)
            q_idx[nv:] = q_idx[0]
            s_idx[nv:] = s_idx[0]
            q_len[nv:] = q_len[0]
            s_len[nv:] = s_len[0]
        yield sel, rows, q_idx, q_len, s_idx, s_len, nv


def align_pairs_sw(
    table: ProteinTable,
    pairs: np.ndarray,
    output_path: str = "blastp_output.tsv",
    batch: int = 512,
    device_scores: bool = True,
) -> str:
    """Align every (i, j, …) pair, write the combined TSV, return path.

    ``device_scores=True`` runs the batched device two-pass kernel for
    every pair's score + start/end coordinates; the host exact DP then
    tracebacks only the bounded [q_start..q_end]×[s_start..s_end]
    window (asserting it reproduces the device score — a full
    device/host cross-check on real data for free). Pairs where
    co-optimal-alignment ties make the two device passes pick different
    alignments fall back to the full host DP, so output is always a
    true optimum. With ``device_scores=False`` everything runs on the
    full host DP (pure-host mode, e.g. when no accelerator is
    attached) — ~20 ms/pair at mean protein length, vs window-bounded
    cost when the device pass narrows it.
    """
    pairs = np.asarray(pairs)
    if pairs.size == 0:  # empty pair list → header-only TSV
        pairs = pairs.reshape(0, 3).astype(np.int64)
    res = residues_to_indices(table.seq_buf).astype(np.int32)
    offsets = table.offsets
    # batches arrive bucket-sorted; lines restore the input pair order
    lines: List[Optional[str]] = [None] * len(pairs)
    for sel, rows, q_idx, q_len, s_idx, s_len, nv in _pair_batches(
        table, pairs, batch, res
    ):
        dev = (
            sw_ends_and_starts_device(q_idx, q_len, s_idx, s_len)
            if device_scores
            else None
        )
        for r, row in enumerate(rows[:nv]):
            i, j = int(row[0]), int(row[1])
            q = res[offsets[j] : offsets[j + 1]]
            s = res[offsets[i] : offsets[i + 1]]
            if dev is None:
                a = sw_align_host(q, s)
            else:
                score, qs, qe, ss, se = (int(x[r]) for x in dev)
                if score == 0:
                    a = LocalAlignment(0, 0, 0, 0, 0, 0, 0, 0)
                else:
                    w = sw_align_host(q[qs - 1 : qe], s[ss - 1 : se])
                    if w.score == score:
                        a = LocalAlignment(
                            score=w.score,
                            q_start=qs - 1 + w.q_start,
                            q_end=qs - 1 + w.q_end,
                            s_start=ss - 1 + w.s_start,
                            s_end=ss - 1 + w.s_end,
                            length=w.length,
                            identities=w.identities,
                            gaps=w.gaps,
                        )
                    else:
                        # co-optimal tie: the forward/reverse device
                        # passes bounded different alignments — take the
                        # exact full DP for this pair
                        a = sw_align_host(q, s)
                        if a.score != score:
                            raise AssertionError(
                                f"device/host SW divergence on pair "
                                f"({i},{j}): {score} vs {a.score}"
                            )
            qlen, slen = len(q), len(s)
            if a.score == 0:
                # no local alignment at all (e.g. an empty sequence):
                # diamond emits no row; the Karlin-Altschul formula would
                # otherwise assign e-value 0.0 — the MOST significant
                # value — to the weakest possible pair
                lines[int(sel[r])] = ""
                continue
            ev = a.evalue(qlen, slen)
            lines[int(sel[r])] = (
                f"{table.ids[j]}\t{qlen}\t{table.ids[i]}\t{slen}\t"
                f"{a.q_start}\t{a.q_end}\t{a.s_start}\t{a.s_end}\t"
                f"{a.length}\t{a.pident:.1f}\t"
                f"{ev:.2e}\t{a.bitscore():.1f}\n"
            )
    with open(output_path, "w") as f:
        f.write(TSV_HEADER)
        f.writelines(lines)
    return output_path
