"""Packed k-mer presence bitsets.

The reference's per-vertex edge-incidence "bit arrays"
(``src/graph/vertex.rs:143-157``, ``src/tree.rs`` u/c bitarrays) are
``Vec<bool>`` — one byte per bit, reallocated per query. Here the whole
dataset is one packed ``[N, W]`` uint32 matrix: protein n contains the
repeated k-mer of rank r iff bit ``r % 32`` (LSB-first) of word
``words[n, r // 32]`` is set. 231,253 repeated 5-mers → 7,227 words →
28.9 KB/protein; 10,619 proteins ≈ 307 MB — comfortably HBM-resident, and
the layout a tiled AND+popcount sweep wants.

Padding: the word axis is padded to a multiple of 128 (so word chunks and
mesh shards divide it evenly) and the protein axis to a multiple of the
sweep tile; pad bits are zero so they
never contribute to a popcount.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class BitsetMatrix:
    """Packed presence matrix plus its true (unpadded) dimensions."""

    words: np.ndarray  # uint32 [N_pad, W_pad]
    n: int             # true protein count
    n_bits: int        # true k-mer (rank-space) count
    # init=False: the cache must NOT survive dataclasses.replace(...,
    # words=other) — a carried-over device array for the OLD words would
    # silently sweep the wrong matrix. replace() re-runs __init__, which
    # resets an init=False field to its default.
    _device_words: object = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def device_words(self):
        """The packed matrix as a device array, uploaded at most once.

        The words matrix is immutable once packed, so repeated
        ``pairwise_similarity`` calls on one bitset share one
        host→device transfer instead of paying it per call. Device engines
        fetch residency through this cache; when ``words`` is already
        a device array (``pack_bitsets_device``) this is free.
        """
        if self._device_words is None:
            import jax.numpy as jnp

            self._device_words = jnp.asarray(self.words)
        return self._device_words

    @property
    def n_pad(self) -> int:
        return int(self.words.shape[0])

    @property
    def w_pad(self) -> int:
        return int(self.words.shape[1])

    def row_bits(self, i: int) -> np.ndarray:
        """Unpacked bool row (testing/debug only)."""
        return _row_bits_impl(self, i)


class _NeverWords:
    """Guard standing in for the dense matrix in packless runs: ANY
    attribute access (shape, dtype, slicing via __getitem__ …) raises
    with the reason, so an accidental dense-path dispatch fails loudly
    instead of computing on zeros."""

    def __getattr__(self, name):
        raise RuntimeError(
            "the dense packed matrix was never materialized "
            "(stream_source='csr' packless run); this code path needs "
            "the host words — re-run with stream_source='host' or a "
            "dense-matrix engine"
        )

    def __getitem__(self, *_):
        self.shape  # raises


@dataclasses.dataclass
class VirtualBitsetMatrix(BitsetMatrix):
    """Geometry-only stand-in for runs that never build the dense
    matrix (the stream engine with the CSR block source): carries the
    padded dims the engines key their tile enumeration on; touching
    ``.words`` raises loudly."""

    pad_rows: int = 0
    pad_words: int = 0

    @classmethod
    def make(cls, n: int, n_bits: int, row_multiple: int = 512,
             word_multiple: int = 128) -> "VirtualBitsetMatrix":
        n_pad = -(-max(n, 1) // row_multiple) * row_multiple
        w_words = -(-max(n_bits, 1) // 32)
        w_pad = -(-w_words // word_multiple) * word_multiple
        return cls(
            words=_NeverWords(), n=n, n_bits=n_bits,
            pad_rows=n_pad, pad_words=w_pad,
        )

    @property
    def n_pad(self) -> int:
        return self.pad_rows

    @property
    def w_pad(self) -> int:
        return self.pad_words

    def device_words(self):
        self.words.shape  # raises with the packless explanation


def _row_bits_impl(bs: BitsetMatrix, i: int) -> np.ndarray:
    bits = np.unpackbits(
        bs.words[i].view(np.uint8), bitorder="little"
    )
    return bits[: bs.n_bits].astype(bool)


def pack_bitsets(
    incidence_protein: np.ndarray,
    incidence_rank: np.ndarray,
    n: int,
    n_bits: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
    chunk_rows: int = 2048,
) -> BitsetMatrix:
    """Pack (protein, rank) incidences into the uint32 presence matrix.

    Chunked over protein rows so the transient bool matrix stays small
    (``chunk_rows × n_bits`` bytes).
    """
    n_pad = _round_up(max(n, 1), row_multiple)
    w = _round_up(max(n_bits, 1), 32) // 32
    w_pad = _round_up(w, word_multiple)

    # Native scatter packer when built (native/ukc_native.cpp) — an order
    # of magnitude faster than the chunked packbits fallback below.
    try:
        from uniprot_kmer_based_clustering_tpu.io import native

        words = native.pack_bits(
            np.asarray(incidence_protein, np.int32),
            np.asarray(incidence_rank, np.int32),
            n_pad,
            w_pad,
        )
        if words is not None:
            return BitsetMatrix(words=words, n=n, n_bits=n_bits)
    except Exception:
        pass

    words = np.zeros((n_pad, w_pad), dtype=np.uint32)

    bit_cols = w_pad * 32
    order = np.argsort(incidence_protein, kind="stable")
    ip = incidence_protein[order]
    ir = incidence_rank[order]
    starts = np.searchsorted(ip, np.arange(0, n + 1, dtype=ip.dtype))

    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        s, e = starts[lo], starts[hi]
        if s == e:
            continue
        bits = np.zeros((hi - lo, bit_cols), dtype=np.uint8)
        bits[ip[s:e] - lo, ir[s:e]] = 1
        packed = np.packbits(bits, axis=1, bitorder="little")
        words[lo:hi] = packed.view(np.uint32)
    return BitsetMatrix(words=words, n=n, n_bits=n_bits)


def pack_bitsets_device(
    incidence_protein: np.ndarray,
    incidence_rank: np.ndarray,
    n: int,
    n_bits: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
) -> BitsetMatrix:
    """Pack the presence matrix ON DEVICE (scatter-add of distinct bits).

    Transferring the (protein, rank) incidences (~8 bytes each) and
    scattering on device is ~70× less host→device traffic than building
    the dense matrix on the host and uploading it. Each (protein, rank) is unique, so the
    scattered powers of two are distinct and add ≡ bitwise-or.

    Returns a BitsetMatrix whose ``words`` is a DEVICE array.
    """
    import jax
    import jax.numpy as jnp

    n_pad = _round_up(max(n, 1), row_multiple)
    w = _round_up(max(n_bits, 1), 32) // 32
    w_pad = _round_up(w, word_multiple)
    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        device_memory_budget,
    )

    nbytes = n_pad * w_pad * 4
    budget = device_memory_budget()
    if nbytes > budget:
        raise ValueError(
            f"packed bitset would be {nbytes / 2**30:.1f} GiB — beyond "
            f"the device's {budget / 2**30:.1f} GiB budget. Shard rows "
            f"over a mesh (parallel.sharded_pairwise_similarity) or the "
            f"k-mer axis (sharded_pairwise_similarity_kaxis), stream it "
            f"(engine='stream'), or reduce the repeated-k-mer universe."
        )

    # Three scale lessons are baked in here:
    #   * the buffer is DONATED through every scatter call so XLA updates
    #     in place (separate operand/result allocations double the matrix
    #     — 2 × 9.2 GB OOM);
    #   * the incidences are scattered in bounded chunks (1M per call),
    #     which bounds the [nnz, 2] index transient whatever its layout;
    #   * indices stay 2-D: a flat 1-D index would overflow, since jax
    #     canonicalizes indices to int32 (x64 off) and the matrix can
    #     exceed 2³¹ words.
    @functools.partial(jax.jit, donate_argnums=(0,))
    def scatter_chunk(words, p, r):
        bit = jnp.left_shift(
            jnp.uint32(1), (r & 31).astype(jnp.uint32)
        )
        return words.at[p, r >> 5].add(bit)

    ip = np.asarray(incidence_protein, np.int32)
    ir = np.asarray(incidence_rank, np.int32)
    chunk = 1 << 20
    # pad the tail chunk with (0, 0) plus a zero bit value so every call
    # shares one compiled shape
    words = jnp.zeros((n_pad, w_pad), jnp.uint32)
    nnz = ip.shape[0]
    if nnz == 0:
        return BitsetMatrix(words=words, n=n, n_bits=n_bits)
    n_chunks = -(-nnz // chunk)
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, nnz)
        if hi - lo == chunk:
            p_c, r_c = ip[lo:hi], ir[lo:hi]
        else:
            # pad with out-of-bounds rows — OOB scatter updates are
            # dropped (jax indexing semantics) — so the tail shares the
            # same compiled shape
            p_c = np.full(chunk, n_pad, np.int32)
            r_c = np.zeros(chunk, np.int32)
            p_c[: hi - lo] = ip[lo:hi]
            r_c[: hi - lo] = ir[lo:hi]
        words = scatter_chunk(words, jnp.asarray(p_c), jnp.asarray(r_c))
    return BitsetMatrix(words=words, n=n, n_bits=n_bits)


def unpack_ranks(bitset: BitsetMatrix, i: int) -> np.ndarray:
    """Rank ids present in row i (testing/debug)."""
    return np.nonzero(bitset.row_bits(i))[0]
