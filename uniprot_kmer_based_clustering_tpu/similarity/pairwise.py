"""Single-chip pairwise similarity sweep: stats + surviving-pair extraction.

Replaces the reference's graph engine (``src/graph/``): the sweep's
aggregate statistics reproduce the stderr counters the reference prints
("Number of total edges", "Number of edges now", src/graph/mod.rs:50-51,
545,695) and the extraction pass reproduces the pair set that
``align_and_output_pairs`` would align (counts > threshold, cross-AMR —
src/graph/mod.rs:242,580-587).

Two-pass extraction under XLA's static shapes (SURVEY.md §7.4): pass 1 is
the fused sweep, which reports per-tile hit counts; pass 2 recomputes the
handful of hit tiles and pulls their counts to host for exact index
recovery. Deterministic: pairs are produced sorted by (i, j).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import BitsetMatrix
from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
    TOPK_CAP as _TOPK_CAP,  # scatter-vs-top_k density crossover
    FusedCandidates,
    bucket_pow2,
    compact_positions,  # re-exported: the sharded extractors import these
    subtile_rows,
    sweep_mxu,
    topk_subtile_candidates,
    unpack_words_to_int8,
)
from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla

#: Device extraction compaction, chosen from timings on the card
#: (PERF.md): per-sub-tile ``lax.top_k`` selection (True) or the
#: cumsum+scatter compaction (False). Coalescing dense hit tiles into
#: superblocks rides on the top_k path. Both stay selectable per call
#: (``extract_pairs(use_topk=..., coalesce=...)``) so tests cover both.
EXTRACT_USE_TOPK = True
EXTRACT_COALESCE = True


def topk_tile_cap(per_tile_hits) -> Optional[int]:
    """The sharded extractors' ``tile_cap``: the densest tile's survivor
    count when the top_k compaction is the default, else None (scatter)."""
    if not EXTRACT_USE_TOPK or not len(per_tile_hits):
        return None
    return int(np.max(per_tile_hits))


#: Per-sub-tile candidate capacity of the fused mesh sweep (0 = scatter
#: compaction, bounded only by the global cap).
FUSED_TOPK_DEFAULT = 512 if EXTRACT_USE_TOPK else 0


def _recompute_block(
    words, weights, classes, i0, j0, size, n, threshold,
    weighted, cross_amr_only, valid,
):
    """Shared tile-recompute preamble of every extraction path: slice the
    [size]-row windows at (i0, j0), redo the matmul counts, and build the
    survivor mask (threshold + triangle + bounds + class filter + batch
    validity). Returns (counts, mask, gi, gj) — [size, size] each."""
    a = jax.lax.dynamic_slice_in_dim(words, i0, size, 0)
    b = jax.lax.dynamic_slice_in_dim(words, j0, size, 0)
    ai = unpack_words_to_int8(a, weights if weighted else None)
    bi = unpack_words_to_int8(b)
    counts = jax.lax.dot_general(
        ai, bi, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (size, size), 0)
    gj = j0 + jax.lax.broadcasted_iota(jnp.int32, (size, size), 1)
    ca = jax.lax.dynamic_slice(classes, (i0,), (size,))
    cb = jax.lax.dynamic_slice(classes, (j0,), (size,))
    mask = (counts > threshold) & (gi < gj) & (gj < n) & valid
    if cross_amr_only:
        mask &= ca[:, None] != cb[None, :]
    return counts, mask, gi, gj


# Sentinel for unused slots in the global pair buffers: sorts past every
# real row index, so the occupied prefix of the device-sorted output is
# exactly the pair list. The count lane uses -1 (scores of surviving
# pairs are ≥ 0 because the mask is `counts > threshold` with
# threshold ≥ 0 on every engine path).
_IMAX = np.int32(np.iinfo(np.int32).max)


def _new_pair_buffers(vcap: int):
    """Fresh global candidate buffers: (bi, bj, bc, cursor), sentinel
    slots (bi = bj = INT32_MAX, bc = −1)."""
    return (
        jnp.full(vcap, _IMAX, jnp.int32),
        jnp.full(vcap, _IMAX, jnp.int32),
        jnp.full(vcap, -1, jnp.int32),
        jnp.int32(0),
    )


# Packed pair-list layout: one int64 per pair, i(24) | j(24) | count(16)
# — sorting the packed value IS the canonical (i, j) sort because every
# surviving pair is unique (exactly one tile owns each (i, j)), so the
# count bits never decide an ordering. Used by the out-of-core
# extractors to fetch 8 bytes/pair instead of 12 (the pair-list fetch
# is a large share of a beyond-memory run's device→host traffic). Valid when
# every row index < 2^23 (8.4M proteins — the i field occupies bits
# 40-63 of a SIGNED int64, so i ≥ 2^23 would set the sign bit and break
# both the sort order and the sign-extending unpack) and every stored
# count < 2^16; the finalize checks both and falls back to the [M, 3]
# format.
_PACK_I_SHIFT = 40
_PACK_J_SHIFT = 16
_PACK_FIELD_MASK = (1 << 24) - 1  # the 24-bit i/j field width
_PACK_ROW_LIMIT = 1 << 23  # validity bound: keeps the sign bit clear
_PACK_COUNT_LIMIT = 1 << 16
_PACK_SENTINEL = np.int64(np.iinfo(np.int64).max)


@jax.jit
def _pack_sort_pairs_x64(bi, bj, bc):
    packed = (
        (bi.astype(jnp.int64) << _PACK_I_SHIFT)
        | (bj.astype(jnp.int64) << _PACK_J_SHIFT)
        | bc.astype(jnp.int64)
    )
    packed = jnp.where(bc < 0, _PACK_SENTINEL, packed)
    return jax.lax.sort(packed), jnp.max(bc).astype(jnp.int64)


def _pack_sort_fetch(bi, bj, bc, total: int, cursor=None):
    """Device finalize for the packed layout: pack the compacted buffers
    into one int64 lane each, single-key sort, slice the occupied
    prefix, fetch. Sentinel slots (bc < 0) pack to INT64_MAX, sorting
    past every real pair — same prefix convention as
    :func:`_sort_pairs`. The repo runs with jax x64 DISABLED (the
    default dtype discipline everywhere else); the int64 lanes exist
    only inside this scoped ``jax.enable_x64`` block — trace, slice and
    fetch all under it, so the values round-trip unclipped.

    The count-range check rides the SAME fetch (each fetched output
    array pays its own device→host round trip): the
    device max of ``bc`` — and, when given, the compaction ``cursor`` —
    travel as extra trailing lanes of the one fetched array. Returns
    ``(pairs, cursor_value)``; ``pairs`` is None when a count reached
    2^16 (the pack would corrupt — callers fall back to [M, 3]), and
    ``cursor_value`` is None unless ``cursor`` was passed."""
    with jax.enable_x64(True):
        sorted_p, mx = _pack_sort_pairs_x64(bi, bj, bc)
        tail = [mx[None]]
        if cursor is not None:
            tail.append(cursor[None].astype(jnp.int64))
        arr = jax.device_get(
            jnp.concatenate([sorted_p[:total]] + tail)
        )
    cur = int(arr[-1]) if cursor is not None else None
    mx_host = int(arr[total])
    if mx_host >= _PACK_COUNT_LIMIT:
        return None, cur
    return arr[:total], cur


def unpack_pairs(packed: np.ndarray) -> np.ndarray:
    """Decode a packed int64 pair list to the canonical [M, 3] int32
    matrix (host-side; costs one pass over the data — prefer consuming
    the packed form directly where possible on bandwidth-starved
    hosts)."""
    out = np.empty((len(packed), 3), np.int32)
    out[:, 0] = packed >> _PACK_I_SHIFT
    out[:, 1] = (packed >> _PACK_J_SHIFT) & _PACK_FIELD_MASK
    out[:, 2] = packed & (_PACK_COUNT_LIMIT - 1)
    return out


def pairs_as_array(pairs: np.ndarray) -> np.ndarray:
    """Canonical [M, 3] int32 view of either pair-list format (packed
    int64 [M] or already-unpacked [M, 3])."""
    return unpack_pairs(pairs) if pairs.ndim == 1 else pairs


def packed_key(i: int, j: int) -> int:
    """Packed value of pair (i, j) with count 0 — the ``searchsorted``
    lower bound for membership tests on a sorted packed pair list (a
    stored pair's value lies in [key, key + 2^16))."""
    return (int(i) << _PACK_I_SHIFT) | (int(j) << _PACK_J_SHIFT)


def packed_pair(v) -> tuple:
    """Decode one packed int64 to (i, j, count)."""
    v = int(v)
    return (
        v >> _PACK_I_SHIFT,
        (v >> _PACK_J_SHIFT) & _PACK_FIELD_MASK,
        v & (_PACK_COUNT_LIMIT - 1),
    )


def _fetch_sorted_pairs(bi, bj, bc, total: int, pair_format: str,
                        n_rows: int):
    """Sort + prefix-slice + fetch the canonical pair list from the
    compacted global buffers. ``pair_format="packed"`` fetches the
    int64 packed layout (8 B/pair) when the ranges fit — row indices
    bounded by ``n_rows``, counts validated from a trailing lane of the
    SAME fetch (no separate probe round trip) — and falls back to the
    [M, 3] int32 format otherwise (count overflow costs the packed
    fetch plus the fallback, but a ≥2^16 shared-k-mer count means a
    ≥2^16-bit-dense row — far outside every supported regime)."""
    if pair_format == "packed" and n_rows < _PACK_ROW_LIMIT:
        arr, _ = _pack_sort_fetch(bi, bj, bc, total)
        if arr is not None:
            return arr
    return jax.device_get(_sort_pairs(bi, bj, bc)[:total])


@jax.jit
def _sort_pairs(bi, bj, bc):
    """Device-side finalize shared by every extraction path: sort the
    compacted candidates by (i, j) and stack the canonical [vcap, 3]
    int32 pair matrix.

    EVERYTHING after compaction happens on device, so no host epilogue
    (mask-gathers, stack, astype(int64), concatenate, lexsort) touches
    the tens of millions of pairs a dense run produces. The host
    receives ONE fetched array and slices a zero-copy view of the
    occupied prefix (sentinel slots sort to the tail).
    """
    si, sj, sc = jax.lax.sort((bi, bj, bc), num_keys=2)
    return jnp.stack([si, sj, sc], axis=1)


def _vcap_bucket(total: int, space: Optional[int] = None) -> int:
    """Bucketed global buffer capacity for an exact survivor count —
    bounds the compiled sort/compact shapes while keeping the padded
    fetch slack small (≤ 1.5 MB at scale). ``space``
    caps the bucket at the physical candidate space when one exists."""
    g = 1 << 17 if total >= 1 << 17 else 1 << 14
    vcap = max(1, (total + g - 1) // g * g)
    if space is not None:
        vcap = max(1, min(space, vcap))
    return vcap


def _finalize_pairs(buffers, expected_total: int,
                    pair_format: str = "arr3",
                    n_rows: int = 0) -> np.ndarray:
    """Sort the global buffers ON DEVICE, slice the occupied prefix
    there (sentinels sort to the tail), and fetch exactly
    ``expected_total`` rows — the buffers may carry large sentinel
    slack (the sort-append window), and fetching it would move tens of
    MB of sentinels to the host. Raises when
    the compacted count disagrees with the sweep's exact tile hits
    (capacity bugs must never truncate). ``pair_format="packed"``
    (with ``n_rows`` the row-index bound) fetches the packed int64
    layout when the ranges fit — see :func:`_pack_sort_pairs_x64`; the
    count-range check and the cursor verification ride that one fetch
    as trailing lanes (no separate probe round trips)."""
    bi, bj, bc, cursor = buffers
    if pair_format == "packed" and 0 < n_rows < _PACK_ROW_LIMIT:
        arr, count = _pack_sort_fetch(
            bi, bj, bc, expected_total, cursor=cursor
        )
        if count != expected_total:
            raise AssertionError(
                f"extraction compacted {count} pairs, sweep stats "
                f"promised {expected_total}"
            )
        if arr is not None:
            return arr
    sorted_dev = _sort_pairs(bi, bj, bc)
    if bi.shape[0] - expected_total > (1 << 20):
        # large sentinel tail (the sort-append slack window at scale):
        # slice on device; _vcap_bucket-sized buffers keep the whole
        # fetch (≤ ~1.5 MB slack) and avoid a per-total slice program
        sorted_dev = sorted_dev[:expected_total]
    arr, count = jax.device_get((sorted_dev, cursor))
    if int(count) != expected_total:
        raise AssertionError(
            f"extraction compacted {int(count)} pairs, sweep stats "
            f"promised {expected_total}"
        )
    return arr[:expected_total]


@functools.partial(
    jax.jit,
    static_argnames=("tile", "weighted", "cross_amr_only"),
)
def _extract_batch(
    gbi, gbj, gbc, cursor,
    words, weights, classes, i0s, j0s, valid_t, n, threshold,
    *, tile: int, weighted: bool, cross_amr_only: bool,
):
    """Recompute a batch of hit tiles and compact the surviving pairs on
    device into the shared global buffers.

    Compacting on device (cumsum positions + mode="drop" scatter per
    scan step) costs ~12 bytes per surviving pair in the one final
    fetch, instead of fetching dense [tile, tile] count blocks. Returns
    updated (gbi, gbj, gbc, cursor).
    """
    vcap = gbi.shape[0]

    def step(carry, idx):
        cursor, bi, bj, bc = carry
        counts, mask, gi, gj = _recompute_block(
            words, weights, classes, i0s[idx], j0s[idx], tile, n,
            threshold, weighted, cross_amr_only, valid_t[idx],
        )
        pos, kept = compact_positions(mask.ravel(), vcap, cursor)
        opts = dict(mode="drop", unique_indices=True)
        bi = bi.at[pos].set(gi.ravel(), **opts)
        bj = bj.at[pos].set(gj.ravel(), **opts)
        bc = bc.at[pos].set(counts.ravel(), **opts)
        return (cursor + kept, bi, bj, bc), None

    (cursor, gbi, gbj, gbc), _ = jax.lax.scan(
        step,
        (cursor, gbi, gbj, gbc),
        jnp.arange(i0s.shape[0]),
    )
    return gbi, gbj, gbc, cursor


def _accumulate_topk(gbi, gbj, gbc, cursor, bi, bj, bc):
    """Append one part's top_k candidates (score ≥ 0 slots) to the
    global buffers — the shared in-jit epilogue of the top_k extract
    batches."""
    vcap = gbi.shape[0]
    m = bc.ravel() >= 0
    pos, kept = compact_positions(m, vcap, cursor)
    opts = dict(mode="drop", unique_indices=True)
    gbi = gbi.at[pos].set(bi.ravel(), **opts)
    gbj = gbj.at[pos].set(bj.ravel(), **opts)
    gbc = gbc.at[pos].set(bc.ravel(), **opts)
    return gbi, gbj, gbc, cursor + kept




@functools.partial(jax.jit, static_argnames=("vcap",))
def _compact_fused(bi, bj, bc, keep, *, vcap: int):
    """Compact the fused sweep's candidate buffers ([P, nsub, k], score
    −1 in unused slots) into one device-sorted [vcap, 3] pair matrix,
    dropping sub-tiles whose ``keep`` flag is False (their exact hit
    count exceeded k — the two-pass extractor redoes them). Returns
    (pairs [vcap, 3] int32 sorted by (i, j), count).

    One flat cumsum+scatter over the whole candidate space, then the
    device sort/stack finalize: this runs ONCE per sweep and the host
    receives a single ready-to-slice fetch."""
    m = (bc >= 0) & keep[:, :, None]
    pos, kept = compact_positions(m.ravel(), vcap)
    opts = dict(mode="drop", unique_indices=True)
    out_i = jnp.full(vcap, _IMAX, jnp.int32).at[pos].set(bi.ravel(), **opts)
    out_j = jnp.full(vcap, _IMAX, jnp.int32).at[pos].set(bj.ravel(), **opts)
    out_c = jnp.full(vcap, -1, jnp.int32).at[pos].set(bc.ravel(), **opts)
    return _sort_pairs(out_i, out_j, out_c), kept


def extract_pairs_fused(
    words,
    classes,
    tile_hits: np.ndarray,
    tiles,
    fused: FusedCandidates,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights=None,
) -> np.ndarray:
    """Fused-mode pair recovery: compact the sweep's own per-sub-tile
    top-k candidates instead of recomputing hit tiles (pass 2 of
    :func:`extract_pairs` re-runs ~a full sweep's worth of matmuls in the
    dense-homology regime — DESIGN.md known-limits).

    Exactness never depends on the capacity guess: the sweep's
    ``tile_hits`` are exact, so any sub-tile whose hit count exceeds
    ``fused.k`` is detected, its (incomplete) candidates dropped, and the
    tile redone by the two-pass machinery.
    """
    ti, tj, tile = tiles
    assert tile == fused.block, "tile enumeration granularity mismatch"
    assert fused.include_same == (not cross_amr_only)
    n_steps = fused.pairs_ij.shape[0]
    nbs = fused.bs // fused.block
    nsub = nbs * nbs
    nb = words.shape[0] // fused.block

    h = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        h = h + tile_hits[:, 1]
    hm = np.zeros((nb, nb), np.int64)
    hm[ti, tj] = h
    s_axis = np.arange(nbs)
    bi_idx = fused.pairs_ij[:, 0:1] // fused.block + s_axis[None, :]
    bj_idx = fused.pairs_ij[:, 1:2] // fused.block + s_axis[None, :]
    # [P, nbs(i), nbs(j)] → [P, nsub]; sub-tiles below the diagonal of a
    # diagonal step aren't in the (ti ≤ tj) enumeration — hm default 0
    h_ps = hm[bi_idx[:, :, None], bj_idx[:, None, :]].reshape(
        n_steps, nsub
    )
    keep = h_ps <= fused.k
    total_kept = int((h_ps * keep).sum())

    parts = []
    if total_kept:
        # bucket the compacted buffer size to bound compiled shapes; the
        # host fetch slices to the exact count (zero-copy view)
        vcap = _vcap_bucket(total_kept, n_steps * nsub * fused.k)
        arr, count = jax.device_get(
            _compact_fused(
                fused.bi, fused.bj, fused.bc, jnp.asarray(keep),
                vcap=vcap,
            )
        )
        if int(count) != total_kept:
            raise AssertionError(
                f"fused compaction found {int(count)} survivors, sweep "
                f"stats promised {total_kept}"
            )
        parts.append(arr[:total_kept])

    if not keep.all():
        # overflow sub-tiles: redo exactly those via two-pass, masking
        # every other tile's hits to zero
        op, osub = np.nonzero(~keep)
        obt_i = bi_idx[op, osub // nbs]
        obt_j = bj_idx[op, osub % nbs]
        rid = np.full((nb, nb), -1, np.int64)
        rid[ti, tj] = np.arange(len(ti))
        rows = rid[obt_i, obt_j]
        assert (rows >= 0).all()  # hits > k > 0 ⇒ in the enumeration
        masked = np.zeros_like(tile_hits)
        masked[rows] = tile_hits[rows]
        parts.append(
            extract_pairs(
                words, classes, masked, tiles, n=n, threshold=threshold,
                cross_amr_only=cross_amr_only, weights=weights,
            )
        )

    if not parts:
        return np.zeros((0, 3), dtype=np.int32)
    if len(parts) == 1:
        return parts[0]  # each part arrives device-sorted by (i, j)
    pairs = np.concatenate(parts, axis=0)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order]


@functools.partial(
    jax.jit,
    static_argnames=("tile", "weighted", "cross_amr_only", "k"),
)
def _extract_batch_topk(
    gbi, gbj, gbc, cursor,
    words, weights, classes, i0s, j0s, valid_t, n, threshold,
    *, tile: int, weighted: bool, cross_amr_only: bool, k: int,
):
    """Recompute a batch of hit tiles, select the surviving pairs with
    ``lax.top_k`` over the hit mask, and append them to the global
    buffers.

    top_k over the 0/1 mask returns the hit positions first (ties keep
    arbitrary order — the final device sort canonicalizes). `k` must be
    ≥ every tile's hit count in the batch — sized from the sweep's exact
    tile_hits, so no overflow is possible. Returns updated (gbi, gbj, gbc, cursor).
    """

    def step(carry, idx):
        i0 = i0s[idx]
        j0 = j0s[idx]
        counts, mask, _, _ = _recompute_block(
            words, weights, classes, i0, j0, tile, n,
            threshold, weighted, cross_amr_only, valid_t[idx],
        )
        gi, gj, cnt = topk_subtile_candidates(
            mask.astype(jnp.int32), counts, i0, j0, tile=tile, k=k
        )
        return carry, (gi[0], gj[0], cnt[0])  # one tile == one sub-tile

    _, (bi, bj, bc) = jax.lax.scan(
        step, 0, jnp.arange(i0s.shape[0])
    )
    return _accumulate_topk(gbi, gbj, gbc, cursor, bi, bj, bc)


@dataclasses.dataclass
class PairwiseResult:
    """Aggregate similarity statistics plus the surviving pair list.

    Attributes map to reference parity counters:
      cross_weight: Σ shared-kmer counts over cross-AMR pairs — the edge
        count after ``remove_uninteresting_edges`` (5,300,233 golden).
      cross_pairs: distinct cross-AMR pairs with ≥1 shared k-mer — the edge
        count after ``combine_edges`` (4,350,628 golden).
      cross_over: pairs over the alignment threshold (465 golden).
      cross_max: maximum shared-k-mer count over cross-AMR pairs (567).
      same_*: the same statistics for class-equal pairs (the reference
        discards these; kept for observability).
      pairs: int32 [M, 3] — (i, j, shared_count) for surviving pairs,
        sorted by (i, j). With cross_amr_only=False both populations
        survive the gate.
      cross_amr_only: the gate mode this result was produced under —
        drives which lanes parity_counters() surfaces (a cross-only run
        reports the reference's golden cross-AMR counters; an
        --all-pairs run must count BOTH populations, matching the
        reference's edge semantics when the filter stage is skipped,
        src/graph/mod.rs:549-697).
    """

    cross_weight: int
    cross_pairs: int
    cross_over: int
    cross_max: int
    same_weight: int
    same_pairs: int
    same_over: int
    same_max: int
    pairs: np.ndarray
    cross_amr_only: bool = True

    @classmethod
    def from_row_stats(
        cls, row_stats, pairs: np.ndarray, cross_amr_only: bool = True
    ) -> "PairwiseResult":
        """Assemble from the engines' canonical [N, 8] row statistics
        (ops.popcount.ROW_STAT_NAMES lane order) — THE single place the
        lane→field mapping lives, so engines cannot drift."""
        rs = np.asarray(row_stats).astype(np.int64)
        totals = rs.sum(axis=0)
        maxes = rs.max(axis=0)
        return cls(
            cross_weight=int(totals[0]),
            cross_pairs=int(totals[1]),
            cross_over=int(totals[2]),
            cross_max=int(maxes[3]),
            same_weight=int(totals[4]),
            same_pairs=int(totals[5]),
            same_over=int(totals[6]),
            same_max=int(maxes[7]),
            pairs=pairs,
            cross_amr_only=cross_amr_only,
        )

    def parity_counters(self) -> Dict[str, int]:
        """Counters matching stats.json / the reference's stderr output.

        Mode-aware: with the AMR gate off (--all-pairs) the filter stage
        is a no-op, so the counters cover cross+same populations — the
        reported numbers always agree with the surfaced `pairs` list."""
        if self.cross_amr_only:
            return {
                "edges_after_amr_filter": self.cross_weight,
                "pairs_after_merge": self.cross_pairs,
                "pairs_over_threshold": self.cross_over,
                "max_shared_kmers": self.cross_max,
            }
        return {
            "edges_after_amr_filter": self.cross_weight + self.same_weight,
            "pairs_after_merge": self.cross_pairs + self.same_pairs,
            "pairs_over_threshold": self.cross_over + self.same_over,
            "max_shared_kmers": max(self.cross_max, self.same_max),
        }


def _coalesce_hit_tiles(ti, tj, want, hits_per_tile, tile, n_pad):
    """Group hit tiles into up-to-3584-wide superblocks when they are
    dense enough.

    The per-tile recompute pays per-scan-step overhead and small-matmul
    efficiency for every hit tile; when most tiles in a region report
    hits, recomputing the
    region as one matmul (compaction stays per-sub-tile, see
    :func:`_extract_superblock_topk`) is a large extraction win. Sparse
    hit patterns (the bundled dataset's 465-pair regime is borderline)
    keep the fine granularity — recomputing a 49× larger block for one
    hit tile would waste MACs and HBM reads.

    Returns (super_ti, super_tj, child_max_hits, q, inv) or None, where
    `inv` maps each hit tile (in `want` order) to its superblock index.
    """
    q = 0
    for cand in range(min(3584 // tile, 28), 0, -1):
        if n_pad % (cand * tile) == 0:
            q = cand
            break
    if q <= 1:
        return None
    nh = int(want.sum())
    if nh == 0:
        return None
    hi = (ti[want] // q).astype(np.int64)
    hj = (tj[want] // q).astype(np.int64)
    key = hi << 32 | hj
    uk, inv = np.unique(key, return_inverse=True)
    if nh / len(uk) < max(4, q):
        return None
    smax = np.zeros(len(uk), np.int64)
    np.maximum.at(smax, inv, hits_per_tile[want])
    return (
        (uk >> 32).astype(np.int32),
        (uk & 0xFFFFFFFF).astype(np.int32),
        smax,
        q,
        inv,
    )


@functools.partial(
    jax.jit,
    static_argnames=("tile", "q", "weighted", "cross_amr_only", "k"),
)
def _extract_superblock_topk(
    gbi, gbj, gbc, cursor,
    words, weights, classes, i0s, j0s, valid_t, child_ok, n, threshold,
    *, tile: int, q: int, weighted: bool, cross_amr_only: bool, k: int,
):
    """Superblock recompute with PER-SUB-TILE top_k compaction, appended
    to the global buffers.

    One [q·tile]² matmul amortizes the per-tile dispatch/slice
    overhead (49× the area per scan step at tile=512, q=7), while
    compaction stays at sub-tile granularity where top_k is cheap —
    batched ``lax.top_k`` over the [q², tile²] reshape. `k` must be ≥
    the densest CHILD tile's hit count (from the sweep's tile_hits).
    ``child_ok`` (bool [batch, q²], sub-tile order of
    :func:`subtile_rows`) keeps only the child tiles the caller asked
    for — a superblock may also cover tiles another pass recovers (the
    fused extractor's overflow redo). Returns updated (gbi, gbj, gbc,
    cursor).
    """
    s = q * tile

    def step(carry, idx):
        i0 = i0s[idx]
        j0 = j0s[idx]
        counts, mask, _, _ = _recompute_block(
            words, weights, classes, i0, j0, s, n,
            threshold, weighted, cross_amr_only, valid_t[idx],
        )
        gi, gj, cnt = topk_subtile_candidates(
            mask.astype(jnp.int32), counts, i0, j0, tile=tile, k=k
        )
        return carry, (gi, gj, jnp.where(child_ok[idx][:, None], cnt, -1))

    _, (bi, bj, bc) = jax.lax.scan(step, 0, jnp.arange(i0s.shape[0]))
    return _accumulate_topk(gbi, gbj, gbc, cursor, bi, bj, bc)


def extract_pairs(
    words,
    classes,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights=None,
    coalesce: Optional[bool] = None,
    use_topk: Optional[bool] = None,
) -> np.ndarray:
    """Pass-2 exact pair recovery from tiles that reported hits.

    `tiles` is the (ti, tj, tile_size) enumeration returned by the sweep
    engine that produced `tile_hits` — the granularities must match.
    With `weights` (int8 per-bit-column), recovered values are the
    BLOSUM-weighted scores instead of raw counts.

    `coalesce` / `use_topk` override the defaults
    (:data:`EXTRACT_COALESCE` / :data:`EXTRACT_USE_TOPK`, chosen from
    timings on the card); tests force both paths.
    """
    if coalesce is None:
        coalesce = EXTRACT_COALESCE
    if use_topk is None:
        use_topk = EXTRACT_USE_TOPK
    ti, tj, tile = tiles
    want = tile_hits[:, 0] > 0
    hits_per_tile = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        want |= tile_hits[:, 1] > 0
        hits_per_tile = hits_per_tile + tile_hits[:, 1]
    hit_tiles = np.nonzero(want)[0]
    if len(hit_tiles) == 0:
        return np.zeros((0, 3), dtype=np.int32)
    # superblock coalescing needs the per-sub-tile top_k compaction
    # (one-giant-tile scatter or top_k both measured slower than the
    # fine path); the densest-child bound keeps each sub-tile's k sane
    coalesced = (
        _coalesce_hit_tiles(
            np.asarray(ti), np.asarray(tj), want, hits_per_tile,
            tile, words.shape[0],
        )
        if (coalesce and use_topk)
        else None
    )
    weighted = weights is not None
    weights_j = jnp.asarray(
        weights if weighted else np.ones(1, np.int8), jnp.int8
    )
    words = jnp.asarray(words)
    # accept length-n classes (public-API contract): pad to n_pad so the
    # in-jit dynamic_slice at edge tiles stays aligned with gi/gj
    # (dynamic_slice CLAMPS out-of-range starts instead of erroring)
    classes = np.asarray(classes, np.int32)
    if classes.shape[0] < words.shape[0]:
        classes = np.concatenate(
            [classes, np.full(words.shape[0] - classes.shape[0], -1, np.int32)]
        )
    classes_j = jnp.asarray(classes, jnp.int32)

    # Tiles recompute as int8 matmuls and the surviving pairs are
    # COMPACTED, SORTED, and STACKED on device (no dense count block and
    # no per-part host epilogue). Every batch appends into ONE global
    # buffer pair-capacity-sized from the sweep's exact tile hits; the
    # host does a single fetch and slices a view. Two compaction
    # strategies by per-tile density:
    #   * top_k selection for tiles with ≤ _TOPK_CAP hits, with k sized
    #     from the sweep's exact per-tile hit counts, bucketed to bound
    #     compiled shapes;
    #   * the cumsum+scatter loop for ultra-dense tiles (threshold-0
    #     full dumps), where k would approach the tile area.
    batch = 128
    total = int(hits_per_tile[hit_tiles].sum())
    vcap = _vcap_bucket(total)
    buffers = _new_pair_buffers(vcap)

    sb_q = 0
    fine = hit_tiles
    if coalesced is not None:
        sti, stj, smax, sb_q, inv = coalesced
        ok = smax <= _TOPK_CAP
        tile_in_ok = ok[inv]  # per hit tile, in want order == hit_tiles order
        fine = hit_tiles[~tile_in_ok]
        sb_sel = np.nonzero(ok)[0]
        sb_sel = sb_sel[np.argsort(-smax[sb_sel])]
        nb = words.shape[0] // tile
        want_map = np.zeros((nb, nb), bool)
        want_map[np.asarray(ti)[want], np.asarray(tj)[want]] = True
        want_map = want_map.reshape(nb // sb_q, sb_q, nb // sb_q, sb_q)
        sb_batch = 16  # padded slots run the full superblock matmul
        for lo in range(0, len(sb_sel), sb_batch):
            g = sb_sel[lo : lo + sb_batch]
            k = bucket_pow2(smax[g].max(), 512, tile * tile)
            i0s = np.zeros(sb_batch, np.int32)
            j0s = np.zeros(sb_batch, np.int32)
            valid_t = np.zeros(sb_batch, bool)
            child_ok = np.zeros((sb_batch, sb_q * sb_q), bool)
            i0s[: len(g)] = sti[g] * (sb_q * tile)
            j0s[: len(g)] = stj[g] * (sb_q * tile)
            valid_t[: len(g)] = True
            child_ok[: len(g)] = want_map[sti[g], :, stj[g], :].reshape(
                len(g), sb_q * sb_q
            )
            buffers = _extract_superblock_topk(
                *buffers,
                words, weights_j, classes_j,
                jnp.asarray(i0s), jnp.asarray(j0s), jnp.asarray(valid_t),
                jnp.asarray(child_ok), np.int32(n), np.int32(threshold),
                tile=tile, q=sb_q, weighted=weighted,
                cross_amr_only=cross_amr_only, k=k,
            )

    hmax = hits_per_tile[fine]
    if use_topk:
        sparse_tiles = fine[hmax <= _TOPK_CAP]
        dense_tiles = fine[hmax > _TOPK_CAP]
    else:
        sparse_tiles = fine[:0]
        dense_tiles = fine

    def _pad_group(g):
        i0s = np.zeros(batch, np.int32)
        j0s = np.zeros(batch, np.int32)
        valid_t = np.zeros(batch, bool)
        i0s[: len(g)] = ti[g] * tile
        j0s[: len(g)] = tj[g] * tile
        valid_t[: len(g)] = True
        return jnp.asarray(i0s), jnp.asarray(j0s), jnp.asarray(valid_t)

    if len(sparse_tiles):
        # sort by hit count so each batch's k bucket fits its tiles
        sparse_tiles = sparse_tiles[np.argsort(-hits_per_tile[sparse_tiles])]
        for lo in range(0, len(sparse_tiles), batch):
            g = sparse_tiles[lo : lo + batch]
            k = bucket_pow2(hits_per_tile[g].max(), 512, tile * tile)
            i0s, j0s, valid_t = _pad_group(g)
            buffers = _extract_batch_topk(
                *buffers,
                words, weights_j, classes_j, i0s, j0s, valid_t,
                np.int32(n), np.int32(threshold),
                tile=tile, weighted=weighted,
                cross_amr_only=cross_amr_only, k=k,
            )

    if len(dense_tiles):
        for lo in range(0, len(dense_tiles), batch):
            g = dense_tiles[lo : lo + batch]
            i0s, j0s, valid_t = _pad_group(np.asarray(g))
            buffers = _extract_batch(
                *buffers,
                words, weights_j, classes_j, i0s, j0s, valid_t,
                np.int32(n), np.int32(threshold),
                tile=tile, weighted=weighted,
                cross_amr_only=cross_amr_only,
            )

    return _finalize_pairs(buffers, total)


def _pairwise_native(
    bitset: BitsetMatrix,
    classes: np.ndarray,
    config: PipelineConfig,
    threshold: int,
    index=None,
    weights=None,
) -> "PairwiseResult":
    """Threaded C++ host sweep (io.native) — bit-identical to the device
    engines (tests/test_native.py pins pair-list equality vs XLA). With
    a host-built KmerIndex available, uses the sparse Gustavson sweep
    (work ∝ Σf(f−1)/2, ~50× less than dense popcount on the bundled
    dataset's 0.13%-dense bitset), which also carries the BLOSUM
    weighted mode; otherwise the AVX-512 dense sweep (unweighted only —
    the caller routes weighted runs without incidences to mxu)."""
    from uniprot_kmer_based_clustering_tpu.io import native

    out = None
    if index is not None and index.has_incidences:
        out = native.sparse_sweep(
            index.incidence_protein,
            index.incidence_rank,
            bitset.n,
            index.n_repeated,
            classes,
            threshold,
            include_same=not config.cross_amr_only,
            weights=weights,
        )
    if out is None and weights is not None:
        # the dispatch reroutes weighted runs to mxu unless the sparse
        # prerequisites held; a dense fallback would silently drop the
        # weighting, so refuse instead
        raise RuntimeError(
            "native weighted sweep unavailable (C++ runtime failed to "
            "load); pick engine='mxu'"
        )
    if out is None:
        out = native.popcount_sweep(
            bitset.words,
            bitset.n,
            classes,
            threshold,
            include_same=not config.cross_amr_only,
        )
    if out is None:
        raise RuntimeError(
            "engine='native' requires the C++ runtime; build it with "
            "`make -C native` or pick engine='xla'"
        )
    row_stats, pairs = out
    return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )


#: The device engine ``engine="auto"`` takes on an accelerator: the
#: int8 matmul sweep measured faster than the packed AND+popcount sweep
#: on the card (PERF.md, engine finding).
DEVICE_ENGINE = "mxu"


def resolve_engine(
    engine: str, platform: str, weighted: bool = False,
    sparse_native: bool = False,
) -> str:
    """The engine a run uses, from the requested ``engine``, the device
    ``platform`` and the inputs.

    ``auto`` is the native C++ sweep on the CPU platform when it is
    built (an XLA:CPU dense sweep is orders of magnitude slower) and
    :data:`DEVICE_ENGINE` on an accelerator. Weighted runs need a matmul
    engine (the weighting is a column scale) unless the native sparse
    sweep can carry the weights (``sparse_native``: host incidences and
    the C++ runtime are both available).
    """
    if engine == "auto":
        if platform == "cpu":
            from uniprot_kmer_based_clustering_tpu.io import native

            engine = "native" if native.available() else "xla"
        else:
            engine = DEVICE_ENGINE
    if weighted and engine == "native" and not sparse_native:
        return "mxu"
    if weighted and engine not in ("native", "stream"):
        return "mxu"
    return engine


def run_engine(config: PipelineConfig, weighted: bool, index=None) -> str:
    """:func:`resolve_engine` for a run on the current default device."""
    sparse_native = False
    if weighted and index is not None and index.has_incidences:
        from uniprot_kmer_based_clustering_tpu.io import native

        sparse_native = native.available()
    return resolve_engine(
        config.engine, jax.devices()[0].platform, weighted, sparse_native
    )


def pairwise_similarity(
    bitset: BitsetMatrix,
    class_ids: np.ndarray,
    config: Optional[PipelineConfig] = None,
    weights: Optional[np.ndarray] = None,
    index=None,
    checkpoint_store=None,
    checkpoint_key: Optional[str] = None,
) -> PairwiseResult:
    """Run the fused sweep + extraction on the current default device.

    `weights` (int8 per-bit-column, from utils.blosum.rank_weights_int8)
    switches the score to BLOSUM-weighted mode; the weighted sweep uses
    a matmul engine (the weighting is a matmul column scale) or the
    native sparse sweep.
    `index` (the KmerIndex the bitset was packed from) lets the native
    engine run its sparse sweep instead of the dense one.
    `checkpoint_store`/`checkpoint_key` enable the stream engine's
    group-boundary checkpointing (ops.stream.sweep_extract_stream): a
    preempted out-of-core pass resumes from the last completed
    stationary group instead of restarting (run_pipeline passes them
    automatically for stream runs with a checkpoint_dir).
    """
    config = config or PipelineConfig()
    n = bitset.n
    n_pad = bitset.n_pad
    classes = np.full(n_pad, -1, dtype=np.int32)
    classes[:n] = np.asarray(class_ids, dtype=np.int32)

    engine = run_engine(config, weights is not None, index)

    threshold = (
        config.effective_weighted_threshold(weights)
        if weights is not None
        else config.threshold
    )

    if config.extract == "onepass" and engine != "stream":
        raise ValueError(
            "extract='onepass' is a stream-engine mode (the one-pass "
            f"out-of-core sweep); resolved engine is {engine!r}"
        )

    if engine == "native":
        return _pairwise_native(
            bitset, classes, config, threshold, index=index,
            weights=weights,
        )

    if engine == "stream":
        # out-of-core: the packed matrix stays in HOST memory and row
        # blocks stream through the device (ops/stream.py) — for corpora
        # beyond one device's memory. Same int8-matmul math as mxu.
        from uniprot_kmer_based_clustering_tpu.ops.stream import (
            extract_pairs_stream_auto,
            extract_pairs_stream_fused,
            sweep_extract_stream,
            sweep_mxu_stream,
        )

        source = None
        if config.stream_source == "csr":
            # on-device block materialization from the incidence lists
            # (CSRBlockSource): host→device traffic drops to one CSR
            # upload. Geometry pinned to the packed matrix's padding so
            # the tile enumeration matches the host-words path exactly.
            if index is None or not getattr(index, "has_incidences", False):
                raise ValueError(
                    "stream_source='csr' needs the host-built index "
                    "incidence lists (index_engine='host')"
                )
            from uniprot_kmer_based_clustering_tpu.ops.stream import (
                CSRBlockSource,
            )

            source = CSRBlockSource(
                index.incidence_protein, index.incidence_rank,
                bitset.n_pad, bitset.w_pad,
            )

        if config.extract == "onepass" or source is not None:
            # stats + survivor compaction in ONE streamed pass: device
            # global pair buffers instead of the fused per-step top-k
            # candidate drain (no capacity guessing, no large-k top_k
            # remote-compile hazard; exact capacity-miss redo)
            row_stats, tile_hits, tiles, pairs = sweep_extract_stream(
                None if source is not None else bitset.words,
                classes, n=n, threshold=threshold,
                bs=config.strip, block=config.tile, weights=weights,
                cross_amr_only=config.cross_amr_only,
                cap=config.extract_k or None,
                block_source=source,
                checkpoint_store=checkpoint_store,
                checkpoint_key=checkpoint_key,
            )
            return PairwiseResult.from_row_stats(
                row_stats, pairs, cross_amr_only=config.cross_amr_only
            )

        if config.extract == "fused":
            # drain survivor candidates inside the sweep's in-flight
            # window — the dense-homology out-of-core regime otherwise
            # re-uploads the whole matrix for extraction. The sweep
            # clamps the capacity to the tile area and records the
            # effective k/mask on the returned StreamCandidates.
            k = config.extract_k or min(512, config.tile * config.tile)
            row_stats, tile_hits, tiles, cands = sweep_mxu_stream(
                bitset.words, classes, n=n, threshold=threshold,
                bs=config.strip, block=config.tile, weights=weights,
                fused_k=k, fused_same=not config.cross_amr_only,
            )
            pairs = extract_pairs_stream_fused(
                bitset.words, classes, tile_hits, tiles, cands,
                n=n, threshold=threshold,
                cross_amr_only=config.cross_amr_only, weights=weights,
            )
            return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )

        row_stats, tile_hits, tiles = sweep_mxu_stream(
            bitset.words, classes, n=n, threshold=threshold,
            bs=config.strip, block=config.tile, weights=weights,
        )
        pairs = extract_pairs_stream_auto(
            bitset.words, classes, tile_hits, tiles,
            n=n, threshold=threshold,
            cross_amr_only=config.cross_amr_only, weights=weights,
        )
        return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )

    # memoized device residency: repeated calls on one bitset upload
    # the packed matrix once
    words = bitset.device_words()
    classes_j = jnp.asarray(classes)
    fused = None
    if engine == "mxu":
        strip = config.strip
        if strip is not None and n_pad % strip != 0:
            strip = config.tile
        # fused extraction: the scan sweep emits its own survivor
        # candidates; falls back to two-pass (fused=None) when the
        # schedule resolves to strips or the memory budget can't carry
        # the candidate buffers
        want_fused = config.extract == "fused"
        out = sweep_mxu(
            words,
            classes_j,
            n=n,
            threshold=threshold,
            strip=strip,
            block=config.tile,
            weights=weights,
            fused_k=(config.extract_k or None) if want_fused else 0,
            fused_same=not config.cross_amr_only,
        )
        row_stats, tile_hits, tiles = out[:3]
        if want_fused:
            fused = out[3]
    else:
        row_stats, tile_hits, tiles = sweep_xla(
            words, classes_j, n=n, threshold=config.threshold,
            tile=config.tile,
        )
    if fused is not None:
        pairs = extract_pairs_fused(
            words,
            classes,
            tile_hits,
            tiles,
            fused,
            n=n,
            threshold=threshold,
            cross_amr_only=config.cross_amr_only,
            weights=weights,
        )
    else:
        pairs = extract_pairs(
            words,
            classes,
            tile_hits,
            tiles,
            n=n,
            threshold=threshold,
            cross_amr_only=config.cross_amr_only,
            weights=weights,
        )

    return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )
