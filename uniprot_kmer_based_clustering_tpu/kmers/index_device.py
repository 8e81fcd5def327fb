"""Device-side index build: doc-freq → rank hash → packed bitsets, all on
the device (k=5).

The 5-mer universe is only 21⁵ = 4,084,101 codes, so the document
frequency is one dense ``bincount`` (distributable with a single ``psum``,
see parallel.doc_freq_psum) and the rank hash is a ``cumsum`` over the
repeated mask — no host sort, no MPHF construction. The packed bitset is
built by a scatter-add of single-bit words: within a protein row each
repeated rank is unique, hence each (row, word, bit) triple is unique and
ADD equals OR.

Produces bit-identical arrays to the host path (kmers/index.py +
kmers/bitset.py) — asserted in tests/test_index_device.py — so the two
paths are interchangeable per stage.

k=7: the 21⁷ ≈ 1.8e9-code universe (still int32 — 21⁷ < 2³¹) is too
large for a dense bincount, so the device build switches to a global
sort over the ~nnz incidence codes (:func:`_device_index_sorted`):
sort → group-id cumsum → per-group counts → repeated-rank cumsum →
inverse-permutation scatter of each incidence's rank → the same
single-bit scatter as k=5. Two passes (sizes are data-dependent; the
first fetches two scalars so the second compiles with static shapes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _check_flat_index_space(n_pad: int, w_pad: int) -> None:
    # the single-bit scatter flattens (row, word) to row*w_pad+word in
    # int32 (x64 is off; astype(int64) would silently stay 32-bit) — past
    # the int32 range the scatter would wrap and corrupt bitsets silently
    if n_pad * w_pad + 1 > 2**31 - 1:
        raise ValueError(
            f"device index build needs N_pad*W_pad < 2^31 flat scatter "
            f"indices (got {n_pad}*{w_pad}); use index_engine='host' at "
            f"this scale"
        )


@functools.partial(jax.jit, static_argnames=("n_pad", "w_pad"))
def _device_index_k5(codes, valid, *, n_pad: int, w_pad: int):
    universe = 21**5
    sent = universe

    # per-protein first-occurrence dedup (sorted rows)
    inc_code = _row_dedup(codes, valid, sent=sent)  # [N, Wmax]

    flat = inc_code.reshape(-1)
    freq = jnp.zeros(universe + 1, jnp.int32).at[flat].add(1)
    freq = freq.at[universe].set(0)

    repeated = freq >= 2
    # rank of code = #repeated codes before it (ascending-code rank — the
    # same dense-rank hash as the host path)
    rank = jnp.cumsum(repeated.astype(jnp.int32)) - 1  # [universe+1]
    n_repeated = rank[universe - 1] + 1

    # scatter single-bit words; (row, word) collisions only occur across
    # distinct bits, so add == or
    r = rank[jnp.minimum(inc_code, universe - 1)]
    keep = (inc_code < sent) & repeated[jnp.minimum(inc_code, universe - 1)]
    word_idx = r >> 5
    bit = (jnp.uint32(1) << (r & 31).astype(jnp.uint32))
    row = jax.lax.broadcasted_iota(
        jnp.int32, inc_code.shape, 0
    )
    flat_idx = jnp.where(keep, row * w_pad + word_idx, n_pad * w_pad)
    words = jnp.zeros(n_pad * w_pad + 1, jnp.uint32)
    words = words.at[flat_idx.reshape(-1)].add(
        jnp.where(keep, bit, 0).reshape(-1)
    )
    return words[:-1].reshape(n_pad, w_pad), freq[:universe], n_repeated


def build_bitset_device(
    residue_idx: np.ndarray,
    lengths: np.ndarray,
    n: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
):
    """Full device index build for k=5.

    Args:
      residue_idx: int32 [N, Lmax] alphabet indices (pad arbitrary).
      lengths: int32 [N] true lengths.

    Returns (words uint32 [N_pad, W_pad] device array, freq int32 [21^5]
    device array, n_repeated int). Matches the host
    ``build_index``+``pack_bitsets`` bit layout exactly.
    """
    from uniprot_kmer_based_clustering_tpu.kmers.encode import (
        encode_kmers_device,
    )

    codes, valid = encode_kmers_device(
        jnp.asarray(residue_idx), jnp.asarray(lengths), 5
    )
    n_pad = -(-max(n, 1) // row_multiple) * row_multiple
    if codes.shape[0] != n_pad:
        pad = n_pad - codes.shape[0]
        codes = jnp.pad(codes, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, ((0, pad), (0, 0)))

    # pass 1: frequency only (cheap), fetched once to size W tightly —
    # W needs a static shape, so the tight n_repeated/32 beats the 21⁵/32
    # universe bound by ~17× on the bundled data
    from uniprot_kmer_based_clustering_tpu.kmers.index import (
        doc_freq_dense_device,
    )

    freq = doc_freq_dense_device(codes, valid, 5)
    n_repeated = int(jnp.sum(freq >= 2))
    w_pad = -(-max(n_repeated, 1) // 32 // word_multiple) * word_multiple
    _check_flat_index_space(n_pad, w_pad)

    words, freq, _ = _device_index_k5(
        codes, valid, n_pad=n_pad, w_pad=w_pad
    )
    # (pass-2 n_repeated parity with pass 1 is asserted by the pipeline
    # against the host index and by tests/test_index_device.py — no
    # extra synchronizing fetch here)
    return words, freq, n_repeated


_SENT = np.int32(2**31 - 1)  # sorts after every k-mer code (21^7 < 2^31)


def _row_dedup(codes, valid, sent=_SENT):
    """Sorted per-row codes with duplicates (and padding) → `sent`.

    The one per-row first-occurrence dedup shared by every device index
    build (k=5 dense, sorted any-k, distributed doc-freq) — the sentinel
    is the only thing that varies (the dense paths use the universe size
    so the bincount can absorb it)."""
    c = jnp.where(valid, codes, sent)
    c = jnp.sort(c, axis=1)
    first = jnp.concatenate(
        [jnp.ones((c.shape[0], 1), bool), c[:, 1:] != c[:, :-1]], axis=1
    )
    return jnp.where(first & (c < sent), c, sent)


@jax.jit
def _sorted_index_sizes(codes, valid):
    """(n_distinct, n_repeated) of the dataset — pass 1 (scalars only)."""
    flat = jnp.sort(_row_dedup(codes, valid).reshape(-1))
    is_code = flat < _SENT
    firstg = (
        jnp.concatenate([jnp.ones(1, bool), flat[1:] != flat[:-1]]) & is_code
    )
    gid = jnp.cumsum(firstg.astype(jnp.int32)) - 1
    m = flat.shape[0]
    counts = jnp.zeros(m + 1, jnp.int32).at[
        jnp.where(is_code, gid, m)
    ].add(1)
    rep_first = firstg & (counts[gid] >= 2)
    return jnp.sum(firstg.astype(jnp.int32)), jnp.sum(
        rep_first.astype(jnp.int32)
    )


@functools.partial(
    jax.jit,
    # n_repeated deliberately NOT in the signature: the body never uses
    # it (w_pad carries the only shape dependence) and a spurious static
    # arg fragments the jit cache — two builds rounding to the same
    # w_pad would each pay a ~60-90 s remote compile
    static_argnames=("n_pad", "w_pad", "n_distinct"),
)
def _device_index_sorted(
    codes, valid, *, n_pad: int, w_pad: int, n_distinct: int
):
    """Sort-based index build (any k): returns (words [n_pad, w_pad],
    unique codes [n_distinct] ascending, doc-freq counts [n_distinct])."""
    inc = _row_dedup(codes, valid)  # [N, Wmax]
    flat = inc.reshape(-1)
    m = flat.shape[0]
    order = jnp.argsort(flat)
    s = flat[order]
    is_code = s < _SENT
    firstg = (
        jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]]) & is_code
    )
    gid = jnp.cumsum(firstg.astype(jnp.int32)) - 1
    gid_safe = jnp.where(is_code, gid, n_distinct)

    counts = jnp.zeros(n_distinct + 1, jnp.int32).at[gid_safe].add(1)
    uniq = jnp.zeros(n_distinct + 1, jnp.int32).at[
        jnp.where(firstg, gid, n_distinct)
    ].set(s)
    repeated = counts[: n_distinct] >= 2
    # ascending-code rank over repeated codes — the dense-rank hash
    grank = jnp.cumsum(repeated.astype(jnp.int32)) - 1

    # rank per sorted element, scattered back to incidence positions
    in_rep = is_code & repeated[jnp.minimum(gid, n_distinct - 1)]
    r_sorted = jnp.where(in_rep, grank[jnp.minimum(gid, n_distinct - 1)], -1)
    rank = jnp.zeros(m, jnp.int32).at[order].set(r_sorted).reshape(inc.shape)

    # single-bit scatter: within a row every rank is unique → add == or
    keep = rank >= 0
    word_idx = rank >> 5
    bit = jnp.uint32(1) << (rank & 31).astype(jnp.uint32)
    row = jax.lax.broadcasted_iota(jnp.int32, inc.shape, 0)
    flat_idx = jnp.where(keep, row * w_pad + word_idx, n_pad * w_pad)
    words = jnp.zeros(n_pad * w_pad + 1, jnp.uint32).at[
        flat_idx.reshape(-1)
    ].add(jnp.where(keep, bit, 0).reshape(-1))
    return (
        words[:-1].reshape(n_pad, w_pad),
        uniq[:n_distinct],
        counts[:n_distinct],
    )


def build_bitset_device_sorted(
    residue_idx: np.ndarray,
    lengths: np.ndarray,
    n: int,
    k: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
):
    """Device index build for any k (sort-based; the k=7 path).

    Returns (words uint32 [N_pad, W_pad], codes int64 [D] ascending,
    doc_freq int64 [D], n_repeated). Bit-identical to the host
    ``build_index`` + ``pack_bitsets`` layout.
    """
    from uniprot_kmer_based_clustering_tpu.kmers.encode import (
        encode_kmers_device,
    )

    codes, valid = encode_kmers_device(
        jnp.asarray(residue_idx), jnp.asarray(lengths), k
    )
    n_pad = -(-max(n, 1) // row_multiple) * row_multiple
    if codes.shape[0] != n_pad:
        pad = n_pad - codes.shape[0]
        codes = jnp.pad(codes, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, ((0, pad), (0, 0)))

    nd, nr = jax.device_get(_sorted_index_sizes(codes, valid))
    n_distinct, n_repeated = int(nd), int(nr)
    w_pad = -(-max(n_repeated, 1) // 32 // word_multiple) * word_multiple
    if n_distinct == 0:
        # every sequence shorter than k: empty index, all-zero bitset
        # (the gathers in _device_index_sorted need ≥1 group)
        return (
            jnp.zeros((n_pad, w_pad), jnp.uint32),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            0,
        )
    _check_flat_index_space(n_pad, w_pad)
    words, uniq, counts = _device_index_sorted(
        codes, valid,
        n_pad=n_pad, w_pad=w_pad,
        n_distinct=n_distinct,
    )
    return (
        words,
        np.asarray(uniq, np.int64),
        np.asarray(counts, np.int64),
        n_repeated,
    )
