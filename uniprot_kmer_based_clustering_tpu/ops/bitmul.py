"""Matmul engine (``engine="mxu"``): shared-k-mer counts as int8 matmuls.

The intersection-count matrix is exactly ``C = B @ B.T`` where ``B`` is the
{0,1} protein×k-mer incidence matrix — a matmul with N²·K ≈ 2.7e13 MACs on
the bundled dataset, which runs on the GPU's int8 tensor cores (s8×s8→s32
``dot_general``). Products are 0/1 and row sums are
< 2³¹, so int32 accumulation is exact: this engine is bit-identical to the
reference's shared-k-mer counts (src/graph/edge.rs `KmerEdgeGroup` k-mer
lists have length == C[i,j]).

The unpacked int8 matrix is 8× the packed bitset (2.5 GB here), so it is
materialized strip-by-strip from the packed words on device; the packed
``[N, W]`` uint32 matrix stays the canonical artifact.

Strips: the protein rows are processed in `strip` blocks; for stationary
strip s only the column suffix j ≥ s·strip is computed (upper triangle at
strip granularity), giving ≤ nS compiled shapes and ~2× work saving for
many strips.

BLOSUM weighting (src/blosum.rs capability) rides the same matmul: the
moving operand's bits are scaled per k-mer column by an integer weight
≤ 127, keeping int8 operands and exact int32 accumulation — weighted
similarity at the same matmul rate.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def subtile_rows(x, bt: int):
    """[R, C] → [R//bt · C//bt, bt²]: each row is one bt² sub-tile
    (row-major over the sub-tile grid) — the batched-top_k layout shared
    by the superblock, sharded, and fused extraction compactors."""
    qi = x.shape[0] // bt
    qj = x.shape[1] // bt
    return (
        x.reshape(qi, bt, qj, bt).transpose(0, 2, 1, 3).reshape(
            qi * qj, bt * bt
        )
    )


def topk_subtile_candidates(mask_i32, counts, i0, j0, *, tile: int, k: int):
    """Per-sub-tile ``lax.top_k`` survivor compaction over one [S, S]
    counts window at global offset (i0, j0).

    The shared selection idiom of the superblock extractor, the fused
    scan sweep, and the single-tile top_k extractor: survivors are
    *selected* per ``tile``² sub-tile (batched top_k over the
    :func:`subtile_rows` layout) instead of scattered, which bounds the
    output to ``k`` slots per sub-tile. ``k`` must be ≥ the densest
    sub-tile's hit count for the
    result to be complete — callers size it from the sweep's exact
    tile_hits (or detect overflow from them, fused path).

    Returns (gi, gj, cnt) int32 [qi·qj, k] — global row, global column,
    score; unused slots carry cnt −1 (ties within a sub-tile keep
    arbitrary order; callers sort the final pair list).
    """
    qi = mask_i32.shape[0] // tile
    qj = mask_i32.shape[1] // tile
    fm = subtile_rows(mask_i32, tile)
    cfl = subtile_rows(counts, tile)
    vals, sel = jax.lax.top_k(fm, k)
    cnt = jnp.where(vals > 0, jnp.take_along_axis(cfl, sel, axis=1), -1)
    sub = jnp.arange(qi * qj, dtype=jnp.int32)
    si = sub // qj
    sj = sub - si * qj
    row = sel // tile
    col = sel - row * tile
    return (
        i0 + si[:, None] * tile + row,
        j0 + sj[:, None] * tile + col,
        cnt,
    )


def bucket_pow2(kmax: int, floor: int, cap: int) -> int:
    """Power-of-two compiled-shape bucket for top_k widths: the smallest
    pow2 ≥ kmax, floored (tiny k buckets churn compiles for no win) and
    capped at the tile area."""
    k = floor
    while k < int(kmax):
        k *= 2
    return min(k, cap)


def compact_positions(keep, cap, cursor=0):
    """Scatter positions for on-device stream compaction.

    Kept elements (``keep`` bool [M]) get ``cursor`` + their rank;
    dropped elements get DISTINCT out-of-bounds slots (cap + lane index)
    so that ``.at[pos].set(..., mode="drop", unique_indices=True)`` is
    honest — a duplicated dummy index would be undefined behavior under
    the hint.

    Returns (pos int32 [M], n_kept int32 scalar).
    """
    ki = keep.astype(jnp.int32)
    pos = cursor + jnp.cumsum(ki) - 1
    pos = jnp.where(
        keep, pos, cap + jnp.arange(keep.shape[0], dtype=jnp.int32)
    )
    return pos, jnp.sum(ki)


@dataclasses.dataclass
class FusedCandidates:
    """Per-sub-tile top-k survivor candidates emitted by the fused scan
    sweep, still resident on device.

    ``bi``/``bj``/``bc`` are int32 [n_steps, nsub, k]: global row index,
    global column index, and score of each candidate; unused slots carry
    score −1. Sub-tile s of step p covers block tile
    (pairs_ij[p,0]//block + s//nbs, pairs_ij[p,1]//block + s%nbs) with
    nbs = bs//block — the same row-major layout as :func:`subtile_rows`.
    A sub-tile whose exact hit count (from the sweep's tile_hits) exceeds
    ``k`` is INCOMPLETE here and must be redone by the two-pass extractor.
    """

    bi: jax.Array
    bj: jax.Array
    bc: jax.Array
    pairs_ij: np.ndarray  # int32 [n_steps, 2] — host copy of the schedule
    bs: int
    block: int
    k: int
    include_same: bool


def unpack_words_to_int8(words, weights: Optional[jnp.ndarray] = None):
    """uint32 packed words [R, W] → int8 bit matrix [R, W*32].

    Bit b (LSB-first) of word w maps to column w*32+b, matching
    ``kmers.bitset.pack_bitsets``. With `weights` (int8 [W*32]), the bit
    columns are scaled — used for the BLOSUM-weighted engine.
    """
    r, w = words.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(r, w * 32).astype(jnp.int8)
    if weights is not None:
        bits = bits * weights[None, :]
    return bits


# Per-tile hit counts above this use the scatter buffer instead of top_k
# (k would approach the tile area; top_k cost grows with k·log).
TOPK_CAP = 1 << 17


def pair_block_stats(counts, ca, cb, i0, j0, *, n, threshold, block,
                     w_thresh):
    """Full XLA statistics epilogue for one [bs, bs] counts block at
    global offset (i0, j0): validity/class masks, the 8-lane row stats,
    and per-`block` sub-tile hit counts.

    THE single implementation shared by the scan sweep and the streaming
    engine — the exact-agreement invariant depends on these masks never
    drifting apart. Returns (rs [bs,8], bh [nbs,nbs,2], over_c, over_s).
    """
    bs = counts.shape[0]
    nbs = bs // block
    gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (bs, bs), 0)
    gj = j0 + jax.lax.broadcasted_iota(jnp.int32, (bs, bs), 1)
    valid = (gi < gj) & (gj < n)
    cross = valid & (ca[:, None] != cb[None, :])
    same = valid & ~cross
    rs, over_c, over_s = stack_row_stats(
        counts, cross, same, threshold, w_thresh
    )
    bh = jnp.stack(
        [
            over_c.astype(jnp.int32)
            .reshape(nbs, block, nbs, block).sum(axis=(1, 3)),
            over_s.astype(jnp.int32)
            .reshape(nbs, block, nbs, block).sum(axis=(1, 3)),
        ],
        axis=-1,
    )
    return rs, bh, over_c, over_s


def merge_row_stats_at(row_stats, rs, i0):
    """THE single row-stats lane-merge rule (ROW_STAT_NAMES contract:
    lanes %4==3 merge by max, the rest by sum), applied at (possibly
    traced) row offset ``i0``. Shared by the scan, stream, AND ring
    engines — the merge semantics must never drift between them."""
    bs = rs.shape[0]
    lanes8 = jnp.arange(8)[None, :]
    prev = jax.lax.dynamic_slice(row_stats, (i0, 0), (bs, 8))
    merged = jnp.where(lanes8 % 4 == 3, jnp.maximum(prev, rs), prev + rs)
    return jax.lax.dynamic_update_slice(row_stats, merged, (i0, 0))


def accumulate_pair_block(row_stats, block_hits, rs, bh, i0, j0, *,
                          block):
    """Merge one block pair's (rs, bh) into the full accumulators at
    (i0, j0) (:func:`merge_row_stats_at` for the stats; hits add).
    Shared by scan and stream."""
    bs = rs.shape[0]
    nbs = bs // block
    row_stats = merge_row_stats_at(row_stats, rs, i0)
    bi, bj = i0 // block, j0 // block
    prev_bh = jax.lax.dynamic_slice(block_hits, (bi, bj, 0), (nbs, nbs, 2))
    block_hits = jax.lax.dynamic_update_slice(
        block_hits, prev_bh + bh, (bi, bj, 0)
    )
    return row_stats, block_hits


def stack_row_stats(counts, cross, same, threshold, w_thresh=1):
    """The canonical 8-lane per-row statistics over one counts block
    (lane layout = ops.popcount.ROW_STAT_NAMES: [cross_weight,
    cross_pairs, cross_over, cross_max, same_weight, same_pairs,
    same_over, same_max]; lanes %4==3 merge by max, the rest by sum).

    Shared by every XLA-epilogue engine (strip, scan, ring) so the stat
    definitions cannot drift apart. Returns (row_stats int32 [S, 8],
    over_c, over_s) — the over-threshold masks drive tile-hit counting.
    """
    czero = jnp.where(cross, counts, 0)
    szero = jnp.where(same, counts, 0)
    over_c = cross & (counts > threshold)
    over_s = same & (counts > threshold)
    row_stats = jnp.stack(
        [
            jnp.sum(czero, axis=1),
            jnp.sum((cross & (counts >= w_thresh)).astype(jnp.int32), axis=1),
            jnp.sum(over_c.astype(jnp.int32), axis=1),
            jnp.max(czero, axis=1),
            jnp.sum(szero, axis=1),
            jnp.sum((same & (counts >= w_thresh)).astype(jnp.int32), axis=1),
            jnp.sum(over_s.astype(jnp.int32), axis=1),
            jnp.max(szero, axis=1),
        ],
        axis=1,
    )
    return row_stats, over_c, over_s


@functools.partial(
    jax.jit,
    static_argnames=(
        "i0", "strip", "n", "threshold", "block", "w_thresh", "word_chunk",
    ),
)
def _strip_stats(
    words,        # uint32 [N_pad, W] full packed matrix
    classes_a,    # int32 [S]
    classes_b,    # int32 [J]
    weights,      # int8 [W*32] or None-like all-ones
    *,
    i0: int,
    strip: int,
    n: int,
    threshold: int,
    block: int,
    w_thresh: int,
    word_chunk: int = 0,
):
    """One stationary strip vs its column suffix: fused matmul + stats.

    The strip/suffix operands are sliced INSIDE the program with static
    offsets so XLA fuses them into the unpack+matmul — slicing outside
    would materialize a device copy of up to the whole packed matrix per
    strip, and with every strip dispatched asynchronously those copies
    coexist (the 100k-scale OOM: 28 strips × up to 10 GB).

    With ``word_chunk`` > 0 the contraction axis is processed in word
    chunks under ``lax.scan`` — the unpacked int8 operands (8× the packed
    bitset) then only ever exist one chunk at a time, bounding peak HBM at
    UniProt scale; the packed matrix stays whole. word_chunk == 0 unpacks
    in one shot (fastest; XLA fuses the unpack into the matmul).

    Returns:
      row_stats int32 [S, 8]  (see ops.popcount.ROW_STAT_NAMES)
      block_hits int32 [S//block, J//block, 2] — #pairs over threshold per
        (row-block, col-block), cross/same — drives exact pair extraction.
    """
    j0 = i0
    n_pad = words.shape[0]
    s = strip
    j = n_pad - i0
    counts = _counts_window(
        words, weights, i0, i0, s=s, jr=j, word_chunk=word_chunk
    )

    gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (s, j), 0)
    gj = j0 + jax.lax.broadcasted_iota(jnp.int32, (s, j), 1)
    valid = (gi < gj) & (gj < n)
    cross = valid & (classes_a[:, None] != classes_b[None, :])
    same = valid & ~cross

    row_stats, over_c, over_s = stack_row_stats(
        counts, cross, same, threshold, w_thresh
    )

    nb_i, nb_j = s // block, j // block
    bh = jnp.stack(
        [
            over_c.astype(jnp.int32)
            .reshape(nb_i, block, nb_j, block)
            .sum(axis=(1, 3)),
            over_s.astype(jnp.int32)
            .reshape(nb_i, block, nb_j, block)
            .sum(axis=(1, 3)),
        ],
        axis=-1,
    )
    return row_stats, bh


def _counts_window(words, weights, ia, ja, *, s, jr, word_chunk=0):
    """int32 counts [s, jr] for the row windows (ia..ia+s) × (ja..ja+jr).

    Both row windows are sliced from the FULL packed matrix inside each
    word-chunk scan step (a [rows, word_chunk] dynamic slice) — slicing
    the row window up front makes XLA materialize it as a scan-invariant
    operand, a second near-full copy of the packed matrix at scale (the
    100k OOM, twice: once as a host-side pre-transpose, once as an
    in-program row slice). `ia`/`ja` may be traced (the scan schedule).
    """
    w_words = words.shape[1]
    if word_chunk and word_chunk < w_words:
        assert w_words % word_chunk == 0
        n_chunks = w_words // word_chunk

        def body(counts, kc):
            ca = jax.lax.dynamic_slice(
                words, (ia, kc * word_chunk), (s, word_chunk)
            )
            cb = jax.lax.dynamic_slice(
                words, (ja, kc * word_chunk), (jr, word_chunk)
            )
            cw = jax.lax.dynamic_slice_in_dim(
                weights, kc * word_chunk * 32, word_chunk * 32, 0
            )
            a = unpack_words_to_int8(ca)
            b = unpack_words_to_int8(cb, cw)
            return (
                counts
                + jax.lax.dot_general(
                    a, b, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.int32,
                ),
                None,
            )

        counts, _ = jax.lax.scan(
            body,
            jnp.zeros((s, jr), jnp.int32),
            jnp.arange(n_chunks, dtype=jnp.int32),
        )
        return counts
    wa = jax.lax.dynamic_slice(words, (ia, 0), (s, w_words))
    wb = jax.lax.dynamic_slice(words, (ja, 0), (jr, w_words))
    a = unpack_words_to_int8(wa)
    b = unpack_words_to_int8(wb, weights)
    return jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )


@functools.partial(
    jax.jit, static_argnames=("word_chunk",)
)
def _strip_counts(words_a, words_b, weights, *, word_chunk: int = 0):
    """Explicit-operand counts (tests / small inputs): int32 [S, J]."""
    return _counts_window_pair(
        words_a, words_b, weights, word_chunk=word_chunk
    )


def _counts_window_pair(words_a, words_b, weights, *, word_chunk=0):
    """Counts for two distinct operand arrays (full windows)."""
    w_words = words_a.shape[1]
    if word_chunk and word_chunk < w_words:
        s, jr = words_a.shape[0], words_b.shape[0]
        n_chunks = w_words // word_chunk

        def body(counts, kc):
            ca = jax.lax.dynamic_slice(
                words_a, (0, kc * word_chunk), (s, word_chunk)
            )
            cb = jax.lax.dynamic_slice(
                words_b, (0, kc * word_chunk), (jr, word_chunk)
            )
            cw = jax.lax.dynamic_slice_in_dim(
                weights, kc * word_chunk * 32, word_chunk * 32, 0
            )
            a = unpack_words_to_int8(ca)
            b = unpack_words_to_int8(cb, cw)
            return (
                counts
                + jax.lax.dot_general(
                    a, b, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.int32,
                ),
                None,
            )

        counts, _ = jax.lax.scan(
            body,
            jnp.zeros((s, jr), jnp.int32),
            jnp.arange(n_chunks, dtype=jnp.int32),
        )
        return counts
    a = unpack_words_to_int8(words_a)
    b = unpack_words_to_int8(words_b, weights)
    return jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "bs", "n", "threshold", "block", "w_thresh", "word_chunk",
        "fused_k", "fused_same",
    ),
)
def _scan_sweep(
    words,       # uint32 [N_pad, W]
    classes,     # int32 [N_pad]
    weights,     # int8 [W*32]
    pairs_ij,    # int32 [P, 2] — (i0, j0) row offsets of each block pair
    *,
    bs: int,
    n: int,
    threshold: int,
    block: int,
    w_thresh: int,
    word_chunk: int = 0,
    fused_k: int = 0,
    fused_same: bool = False,
):
    """Upper-triangle block-pair sweep as ONE compiled ``lax.scan``.

    The strip schedule compiles one program per strip (suffix shapes all
    differ) — 28 compiles at the 100k scale. This schedule instead walks
    equal-size [bs, bs] block pairs with *traced* offsets: a single
    compiled shape for any N_pad. Strips stay the default below ~8 strips
    and the scan takes over at scale.

    With ``fused_k`` > 0 each step also emits its surviving pairs as
    per-sub-tile ``lax.top_k`` candidate rows (the superblock extractor's
    compaction, fused into the sweep so the dense-homology regime never
    recomputes its hit tiles — DESIGN.md "fused extraction").
    ``fused_same`` widens the survivor mask to same-class pairs
    (cross_amr_only=False runs).

    Returns (row_stats int32 [N_pad, 8], block_hits int32 [nb, nb, 2],
    ys) where ys is None or int32 (gi, gj, cnt) each [P, nbs², fused_k],
    cnt −1 in unused slots.
    """
    n_pad, w_words = words.shape
    nb = n_pad // block

    def body(carry, ij):
        row_stats, block_hits = carry
        i0, j0 = ij[0], ij[1]
        ca = jax.lax.dynamic_slice(classes, (i0,), (bs,))
        cb = jax.lax.dynamic_slice(classes, (j0,), (bs,))
        counts = _counts_window(
            words, weights, i0, j0, s=bs, jr=bs, word_chunk=word_chunk
        )

        rs, bh, over_c, over_s = pair_block_stats(
            counts, ca, cb, i0, j0,
            n=n, threshold=threshold, block=block, w_thresh=w_thresh,
        )
        ys = None
        if fused_k:
            em = (over_c | over_s) if fused_same else over_c
            ys = topk_subtile_candidates(
                em.astype(jnp.int32), counts, i0, j0,
                tile=block, k=fused_k,
            )
        row_stats, block_hits = accumulate_pair_block(
            row_stats, block_hits, rs, bh, i0, j0, block=block
        )
        return (row_stats, block_hits), ys

    init = (
        jnp.zeros((n_pad, 8), jnp.int32),
        jnp.zeros((nb, nb, 2), jnp.int32),
    )
    (row_stats, block_hits), ys = jax.lax.scan(body, init, pairs_ij)
    return row_stats, block_hits, ys


def auto_strip(n_pad: int, block: int, budget_bytes: int = 2 << 30) -> int:
    """Pick the stationary strip size.

    ns strips of [n_pad/ns rows × the j ≥ strip-start column suffix] skip
    the lower triangle at strip granularity — (ns+1)/(2·ns) of the full
    square's MACs — and, with async dispatch + batched readback, run at
    full matmul rate. Each strip is its own compiled shape, so ns is
    capped at 8 (past which sweep_mxu_async's auto schedule switches to
    the one-shape scan anyway). Small problems stay one full-square call
    — fewest compiled shapes; large-N strips also shrink to keep each
    int32 counts block under `budget_bytes`. This geometry (3584-row
    strips, 512-row blocks) has not been tuned on the GPU.
    """
    if n_pad <= 3584:
        return n_pad
    cap = max(block, budget_bytes // (n_pad * 4))
    if 8192 < n_pad <= 16384:
        # smallest block-multiple divisor with ns ≤ 8 — the most
        # triangle skipped for a bounded compiled-shape count. Only in
        # this window: above it the one-compiled-shape scan schedule
        # (auto-selected when ns > 8) has a better MAC ratio AND no
        # per-strip compiles.
        for mult in range(1, cap // block + 1):
            s = mult * block
            if n_pad % s == 0 and n_pad // s <= 8:
                return s
    # mid-size problems (or budget-capped large ones): largest divisor
    # ≤ min(cap, 3584); favors few shapes over the last MAC savings
    cap = min(3584, cap)
    best = block
    for mult in range(1, cap // block + 1):
        s = mult * block
        if n_pad % s == 0:
            best = s
    return best


def resolve_schedule(n_pad: int, block: int, strip: Optional[int] = None,
                     schedule: str = "auto"):
    """The strip/scan decision :func:`sweep_mxu_async` makes, exported so
    harnesses can report the same reason without re-implementing it.
    Returns (schedule, strip, ns)."""
    if strip is None:
        strip = auto_strip(n_pad, block)
    ns = n_pad // strip
    if schedule == "auto":
        # each strip compiles its own program (distinct suffix shapes);
        # beyond ~8 strips the one-shape block-pair scan saves compiles
        schedule = "scan" if ns > 8 else "strips"
    return schedule, strip, ns


def sweep_mxu_async(
    words,
    classes,
    n: int,
    threshold: int,
    strip: Optional[int] = None,
    block: int = 512,
    weights: Optional[np.ndarray] = None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    schedule: str = "auto",
    fused_k: Optional[int] = 0,
    fused_same: bool = False,
):
    """Dispatch the full sweep; return (device_results, finalize).

    Device work is enqueued without any synchronizing host fetch —
    back-to-back sweeps pipeline on device (steady-state throughput;
    bench.py measures this). ``finalize(device_results)`` fetches and
    assembles the standard (row_stats, tile_hits, tiles) outputs.

    ``fused_k`` requests fused extraction (scan schedule only): 0 = off,
    None = auto-size the per-sub-tile candidate capacity from the HBM
    budget, >0 = explicit capacity. When requested (non-0), finalize
    returns a 4th element — a :class:`FusedCandidates` with the
    device-resident survivor candidates, or None when the resolved
    schedule/budget can't support fusion (caller falls back to two-pass
    extraction). ``fused_same`` includes same-class survivors
    (cross_amr_only=False runs). ``hbm_budget_bytes`` defaults to
    :func:`utils.accel.device_memory_budget`.
    """
    if hbm_budget_bytes is None:
        from uniprot_kmer_based_clustering_tpu.utils.accel import (
            device_memory_budget,
        )

        hbm_budget_bytes = device_memory_budget()
    n_pad, w_words = words.shape
    fused_requested = fused_k != 0
    schedule, strip, ns = resolve_schedule(n_pad, block, strip, schedule)
    assert n_pad % strip == 0 and strip % block == 0
    nb = n_pad // block
    fused_bytes = 0
    if schedule != "scan":
        fused_k = 0  # the strip programs have no in-sweep compaction
    elif fused_requested:
        n_steps = ns * (ns + 1) // 2
        nsub = (strip // block) ** 2
        if fused_k is None:
            # auto: largest pow2 capacity whose candidate buffers fit the
            # fused slice of the HBM budget; below 512 the overflow-redo
            # rate would defeat the point — fall back to two-pass
            ys_budget = min(1536 << 20, hbm_budget_bytes // 8)
            kb = ys_budget // max(n_steps * nsub * 12, 1)
            fused_k = 0
            if kb >= min(512, block * block):
                fused_k = min(512, block * block)
                while fused_k * 2 <= kb and fused_k * 2 <= block * block:
                    fused_k *= 2
        else:
            # a sub-tile has block² entries — capacity beyond that is
            # meaningless (top_k would reject it)
            fused_k = min(fused_k, block * block)
        if n_steps * nsub * fused_k >= 1 << 31:
            # the compactor's flat cumsum positions are int32
            raise ValueError(
                f"fused_k={fused_k} overflows the int32 candidate space "
                f"({n_steps} steps × {nsub} sub-tiles)"
            )
        fused_bytes = n_steps * nsub * fused_k * 12
    else:
        fused_k = 0
    if word_chunk is None:
        # Chunk the contraction when the unpacked int8 operands would
        # exceed what HBM has left after the residents (packed words +
        # the int32 counts block); pick the largest 128-multiple divisor
        # of w_words whose unpacked chunk (both operands) fits.
        word_chunk = 0
        j_rows = strip if schedule == "scan" else n_pad
        resident = n_pad * w_words * 4 + strip * j_rows * 4 + fused_bytes
        budget = max(512 << 20, hbm_budget_bytes - resident)
        if (strip + j_rows) * w_words * 32 > budget:
            target = max(128, budget // ((strip + j_rows) * 32))
            base = w_words // 128
            best = 1
            for d in range(1, base + 1):
                if base % d == 0 and d * 128 <= target:
                    best = d
            word_chunk = best * 128

    classes = jnp.asarray(classes, jnp.int32)
    if weights is None:
        wts = jnp.ones(w_words * 32, jnp.int8)
    else:
        wts = jnp.asarray(weights, jnp.int8)
        assert wts.shape[0] == w_words * 32

    if schedule == "scan":
        ii, jj = np.triu_indices(ns)
        pairs_np = (np.stack([ii, jj], axis=1) * strip).astype(np.int32)
        pairs_ij = jnp.asarray(pairs_np)
        rs, bh, ys = _scan_sweep(
            words, classes, wts, pairs_ij,
            bs=strip, n=n, threshold=threshold, block=block,
            w_thresh=w_thresh, word_chunk=word_chunk,
            fused_k=fused_k, fused_same=fused_same,
        )
        cands = None
        if fused_k:
            cands = FusedCandidates(
                bi=ys[0], bj=ys[1], bc=ys[2], pairs_ij=pairs_np,
                bs=strip, block=block, k=fused_k,
                include_same=fused_same,
            )

        def finalize_scan(device_results):
            rs, bh = jax.device_get(device_results)
            from uniprot_kmer_based_clustering_tpu.ops.popcount import (
                upper_triangle_tiles,
            )

            ti, tj = upper_triangle_tiles(n_pad, block)
            base = (
                rs.astype(np.int64),
                bh[ti, tj],
                (ti, tj, block),
            )
            return base + (cands,) if fused_requested else base

        return (rs, bh), finalize_scan

    # Dispatch every strip asynchronously, then fetch all results in ONE
    # device→host transfer (a synchronizing readback per strip would
    # serialize the strips on the round trip).
    device_results = []
    for si in range(ns):
        i0 = si * strip
        if ns == 1:
            ca = cb = classes
        else:
            # class slices are tiny; the big word operands are sliced
            # INSIDE the jit with static offsets (no device copies)
            ca = jax.lax.dynamic_slice_in_dim(classes, i0, strip)
            cb = jax.lax.dynamic_slice_in_dim(classes, i0, n_pad - i0)
        device_results.append(_strip_stats(
            words, ca, cb, wts,
            i0=i0, strip=strip, n=n, threshold=threshold, block=block,
            w_thresh=w_thresh, word_chunk=word_chunk,
        ))

    def finalize(device_results):
        host_results = jax.device_get(device_results)
        row_stats = np.zeros((n_pad, 8), dtype=np.int64)
        block_hits = np.zeros((nb, nb, 2), dtype=np.int32)
        for si, (rs, bh) in enumerate(host_results):
            i0 = si * strip
            row_stats[i0 : i0 + strip] = rs.astype(np.int64)
            block_hits[i0 // block :, i0 // block :][: strip // block] += bh

        # Convert block hits to the upper-triangle tile enumeration shared
        # with the popcount engines.
        from uniprot_kmer_based_clustering_tpu.ops.popcount import (
            upper_triangle_tiles,
        )

        ti, tj = upper_triangle_tiles(n_pad, block)
        tile_hits = block_hits[ti, tj]  # [nT, 2]
        base = (row_stats, tile_hits, (ti, tj, block))
        return base + (None,) if fused_requested else base

    return device_results, finalize


def sweep_mxu(
    words,
    classes,
    n: int,
    threshold: int,
    strip: Optional[int] = None,
    block: int = 512,
    weights: Optional[np.ndarray] = None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    schedule: str = "auto",
    fused_k: Optional[int] = 0,
    fused_same: bool = False,
):
    """Full upper-triangle sweep as int8 matmuls (synchronous).

    Args mirror :func:`ops.popcount.sweep_xla`; `weights` enables the
    BLOSUM-weighted engine (int8 per-k-mer column weights). `w_thresh` is
    the count considered "present" for the pairs counter (1 for raw counts;
    the minimum positive weight for weighted scores).

    Returns (row_stats int64 [N_pad, 8], tile_hits int32 [n_tiles, 2],
             tiles (ti, tj, block)) in the same tile enumeration as the
    popcount engines so extraction is engine-agnostic. When ``fused_k``
    is non-0 (fused extraction requested) a 4th element is appended: a
    :class:`FusedCandidates`, or None when the resolved schedule/budget
    can't support fusion — callers unpack 4 values whenever they pass
    ``fused_k`` and fall back to two-pass extraction on None. All strips are
    dispatched asynchronously and fetched with one device→host transfer;
    :func:`sweep_mxu_async` exposes the dispatch/finalize split for
    pipelined back-to-back sweeps.
    """
    device_results, finalize = sweep_mxu_async(
        words, classes, n, threshold,
        strip=strip, block=block, weights=weights, w_thresh=w_thresh,
        word_chunk=word_chunk, hbm_budget_bytes=hbm_budget_bytes,
        schedule=schedule,
        fused_k=fused_k, fused_same=fused_same,
    )
    return finalize(device_results)
