"""On-device batched seeding: canonical closed syncmers + randstrobe
linking + index lookup as jax ops over padded read batches.

This is the device seeding design from SURVEY.md §7.2: the reference's
per-base SyncmerIterator automaton (/root/reference/src/randstrobes.cpp:
57-118) becomes a `lax.scan` over base positions with every read in the
batch advancing in lock-step on the lanes; randstrobe linking
(src/randstrobes.cpp:148-202) becomes masked window ops; index lookup
(src/index.hpp:57-81) becomes a batched searchsorted + bucket-bound
check against the device-resident hash array.

Bit-exact against the host implementations (seed/syncmers.py,
seed/randstrobes.py, index/strobemer_index.py) — see
tests/test_seed_device.py. The production pipeline seeds on the host
(the C++ engine) by default; `--device-seed` moves the second-hottest CPU
loop onto the accelerator. Which wins on the GPU is not measured yet.

All hashes are uint64: the package enables jax x64 at import.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

U64 = jnp.uint64
UMAX = jnp.uint64(0xFFFFFFFFFFFFFFFF)


def xxh64_u64(x):
    """xxh64 of one uint64 (seed/hash.py, reference src/hash.hpp:110-123)."""
    P1 = jnp.uint64(0x9E3779B185EBCA87)
    P2 = jnp.uint64(0xC2B2AE3D27D4EB4F)
    P3 = jnp.uint64(0x165667B19E3779F9)
    P4 = jnp.uint64(0x85EBCA77C2B2AE63)
    P5 = jnp.uint64(0x27D4EB2F165667C5)
    x = x.astype(jnp.uint64)
    r = P5 + jnp.uint64(8)
    x = x * P2
    x = (x << jnp.uint64(31)) | (x >> jnp.uint64(33))
    r = r ^ (x * P1)
    r = (r << jnp.uint64(27)) | (r >> jnp.uint64(37))
    r = r * P1 + P4
    r = r ^ (r >> jnp.uint64(33))
    r = r * P2
    r = r ^ (r >> jnp.uint64(29))
    r = r * P3
    r = r ^ (r >> jnp.uint64(32))
    return r


@functools.partial(jax.jit, static_argnames=("k", "s", "t", "max_syncmers"))
def syncmers_device(codes, lengths, k: int, s: int, t: int, max_syncmers: int):
    """Batched canonical closed syncmers.

    codes: (B, L) uint8 in {0..3, 4=N}; lengths: (B,) int32.
    Returns (positions (B, M) int32 [-1 padded], hashes (B, M) uint64,
    counts (B,) int32) with M = max_syncmers; syncmers beyond M are
    dropped (M = L is always enough).
    """
    B, L = codes.shape
    w = k - s + 1
    kmask = jnp.uint64((1 << (2 * k)) - 1)
    smask = jnp.uint64((1 << (2 * s)) - 1)
    kshift = jnp.uint64((k - 1) * 2)
    sshift = jnp.uint64((s - 1) * 2)

    def step(state, i):
        xk0, xk1, xs0, xs1, l, ring, minval, minpos = state
        c = codes[:, i].astype(jnp.uint64)
        is_base = codes[:, i] < 4
        cc = jnp.where(is_base, c, jnp.uint64(0))
        xk0n = ((xk0 << jnp.uint64(2)) | cc) & kmask
        xk1n = (xk1 >> jnp.uint64(2)) | ((jnp.uint64(3) - cc) << kshift)
        xs0n = ((xs0 << jnp.uint64(2)) | cc) & smask
        xs1n = (xs1 >> jnp.uint64(2)) | ((jnp.uint64(3) - cc) << sshift)
        ln = jnp.where(is_base, l + 1, 0)
        # reset rolling state on N (the automaton zeroes everything)
        xk0n = jnp.where(is_base, xk0n, jnp.uint64(0))
        xk1n = jnp.where(is_base, xk1n, jnp.uint64(0))
        xs0n = jnp.where(is_base, xs0n, jnp.uint64(0))
        xs1n = jnp.where(is_base, xs1n, jnp.uint64(0))

        have_smer = is_base & (ln >= s)
        ys = jnp.minimum(xs0n, xs1n)
        hash_s = xxh64_u64(ys)

        # shift register of the last w s-mer hashes; slot j holds the s-mer
        # whose k-window start is i - k + j + 1
        ring_n = jnp.where(
            have_smer[:, None],
            jnp.concatenate([ring[:, 1:], hash_s[:, None]], axis=1),
            ring,
        )
        n_smers = ln - (s - 1)  # how many s-mers since reset (when >=1)
        first_full = have_smer & (n_smers == w)
        steady = have_smer & (n_smers > w)

        # leftmost minimum (fresh window): argmin takes the first
        left_arg = jnp.argmin(ring_n, axis=1).astype(jnp.int32)
        left_val = jnp.take_along_axis(ring_n, left_arg[:, None].astype(jnp.int64), axis=1)[:, 0]
        # rightmost minimum (rescan after the tracked min slid out)
        right_arg = (w - 1 - jnp.argmin(ring_n[:, ::-1], axis=1)).astype(jnp.int32)
        right_val = jnp.take_along_axis(ring_n, right_arg[:, None].astype(jnp.int64), axis=1)[:, 0]

        slid_out = steady & (minpos == i - k)
        take_new = steady & ~slid_out & (hash_s < minval)

        pos_of = lambda arg: (i - k + 1 + arg).astype(jnp.int32)
        minval_n = jnp.where(
            first_full, left_val,
            jnp.where(slid_out, right_val, jnp.where(take_new, hash_s, minval)),
        )
        minpos_n = jnp.where(
            first_full, pos_of(left_arg),
            jnp.where(slid_out, pos_of(right_arg),
                      jnp.where(take_new, jnp.int32(i - s + 1), minpos)),
        )
        # reset tracking on N
        minval_n = jnp.where(is_base, minval_n, UMAX)
        minpos_n = jnp.where(is_base, minpos_n, jnp.int32(-1))

        emit = (first_full | steady) & (minpos_n == i - k + t) & (i < lengths)
        yk = jnp.minimum(xk0n, xk1n)
        out_hash = xxh64_u64(yk)
        out_pos = jnp.full((B,), i - k + 1, jnp.int32)
        return (
            (xk0n, xk1n, xs0n, xs1n, ln, ring_n, minval_n, minpos_n),
            (emit, out_pos, out_hash),
        )

    zero64 = jnp.zeros((B,), jnp.uint64)
    state0 = (
        zero64, zero64, zero64, zero64,
        jnp.zeros((B,), jnp.int32),
        jnp.full((B, w), UMAX, jnp.uint64),
        jnp.full((B,), UMAX, jnp.uint64),
        jnp.full((B,), -1, jnp.int32),
    )
    _, (emits, poss, hashes) = jax.lax.scan(step, state0, jnp.arange(L))
    emits = emits.T  # (B, L)
    poss = poss.T
    hashes = hashes.T

    # compact per lane into (B, M)
    rank = jnp.cumsum(emits.astype(jnp.int32), axis=1) - 1
    counts = jnp.sum(emits, axis=1).astype(jnp.int32)
    M = max_syncmers
    target = jnp.where(emits, jnp.minimum(rank, M - 1), M)  # M = dropped
    out_pos = jnp.full((B, M + 1), -1, jnp.int32)
    out_hash = jnp.zeros((B, M + 1), jnp.uint64)
    bidx = jnp.arange(B)[:, None].astype(jnp.int64)
    out_pos = out_pos.at[bidx, target.astype(jnp.int64)].set(poss)
    out_hash = out_hash.at[bidx, target.astype(jnp.int64)].set(hashes)
    counts = jnp.minimum(counts, M)
    return out_pos[:, :M], out_hash[:, :M], counts


@functools.partial(jax.jit, static_argnames=("w_min", "w_max", "max_dist", "k"))
def link_randstrobes_device(positions, hashes, counts, w_min: int, w_max: int,
                            q: int, max_dist: int, k: int):
    """Batched randstrobe linking (seed/randstrobes.py link_randstrobes):
    for strobe1 = syncmer i, partner = syncmer j in [i+w_min,
    min(i+w_max, n-1)] with pos <= pos_i + max_dist minimizing
    popcount((h_i ^ h_j) & q); leftmost tie wins; empty window pairs the
    strobe with itself. Returns (hash (B, M) uint64, p1 (B, M) int32,
    p2 (B, M) int32, n_out (B,) int32) where entry m pairs syncmer m
    (valid for m < n_out = max(0, count - w_min))."""
    B, M = hashes.shape
    width = w_max - w_min + 1
    qmask = jnp.uint64(q)

    idx = jnp.arange(M, dtype=jnp.int32)[None, :]  # (1, M)
    j_idx = idx[:, :, None] + w_min + jnp.arange(width, dtype=jnp.int32)[None, None, :]
    j_clip = jnp.minimum(j_idx, jnp.maximum(counts[:, None, None] - 1, 0)).astype(jnp.int64)
    valid = j_idx < counts[:, None, None]
    cand_pos = jnp.take_along_axis(positions, j_clip.reshape(B, -1), axis=1).reshape(B, M, width)
    valid = valid & (cand_pos <= positions[:, :, None] + max_dist)
    cand_hash = jnp.take_along_axis(hashes, j_clip.reshape(B, -1), axis=1).reshape(B, M, width)
    xor = hashes[:, :, None] ^ cand_hash
    metric = jax.lax.population_count(xor & qmask).astype(jnp.int64)
    metric = jnp.where(valid, metric, jnp.int64(1) << 40)
    best = jnp.argmin(metric, axis=2).astype(jnp.int32)  # leftmost min
    any_valid = jnp.any(valid, axis=2)
    strobe2 = jnp.where(any_valid, idx + w_min + best, idx).astype(jnp.int64)
    strobe2 = jnp.minimum(strobe2, jnp.int64(M - 1))
    h2 = jnp.take_along_axis(hashes, strobe2, axis=1)
    p2 = jnp.take_along_axis(positions, strobe2, axis=1)
    rs_hash = hashes + h2
    n_out = jnp.maximum(counts - w_min, 0)
    return rs_hash, positions, p2, n_out


@functools.partial(
    jax.jit, static_argnames=("k", "s", "t", "w_min", "w_max", "max_dist", "max_syncmers")
)
def randstrobes_query_device(codes, lengths, k: int, s: int, t: int,
                             w_min: int, w_max: int, q: int, max_dist: int,
                             max_syncmers: int):
    """Batched query randstrobes for both strands
    (seed/randstrobes.py randstrobes_query / reference
    src/randstrobes.cpp:207-253). Returns (hash (B, 2M) uint64,
    start (B, 2M) int32, end (B, 2M) int32, is_rc (B, 2M) bool,
    n_fwd (B,), n_rc (B,)); rows [0, n_fwd) and [M, M + n_rc) are valid.
    Reads shorter than w_max produce nothing."""
    B, L = codes.shape
    pos, h, counts = syncmers_device(codes, lengths, k, s, t, max_syncmers)
    counts = jnp.where(lengths >= w_max, counts, 0)
    M = pos.shape[1]

    fh, f1, f2, n_fwd = link_randstrobes_device(pos, h, counts, w_min, w_max,
                                                q, max_dist, k)

    # reverse strand: reverse the syncmer list, mirror positions
    idxs = jnp.arange(M, dtype=jnp.int32)[None, :]
    src = (counts[:, None] - 1 - idxs)
    src_clip = jnp.maximum(src, 0).astype(jnp.int64)
    rpos_raw = jnp.take_along_axis(pos, src_clip, axis=1)
    rpos = jnp.where(src >= 0, lengths[:, None] - rpos_raw - k, -1)
    rh = jnp.where(src >= 0, jnp.take_along_axis(h, src_clip, axis=1), jnp.uint64(0))
    bh, b1, b2, n_rc = link_randstrobes_device(rpos, rh, counts, w_min, w_max,
                                               q, max_dist, k)

    out_hash = jnp.concatenate([fh, bh], axis=1)
    out_start = jnp.concatenate([f1, b1], axis=1)
    out_end = jnp.concatenate([f2 + k, b2 + k], axis=1)
    is_rc = jnp.concatenate(
        [jnp.zeros((B, M), bool), jnp.ones((B, M), bool)], axis=1
    )
    return out_hash, out_start, out_end, is_rc, n_fwd, n_rc


@jax.jit
def index_find_device(index_hashes, bucket_starts, bits, query_hashes):
    """Batched StrobemerIndex.find (index/strobemer_index.py): bucket-bound
    binary search for the first entry of each query hash; -1 when absent
    (including the skipped-first-run quirk of the bucket table).
    index arrays are device-resident; query_hashes any shape."""
    pos = jnp.searchsorted(index_hashes, query_hashes)
    tops = (query_hashes >> (jnp.uint64(64) - bits.astype(jnp.uint64))).astype(jnp.int64)
    lo = bucket_starts[tops].astype(jnp.int64)
    hi = bucket_starts[tops + 1].astype(jnp.int64)
    n = index_hashes.shape[0]
    in_range = (pos >= lo) & (pos < hi) & (pos < n)
    safe = jnp.where(pos < n, pos, 0)
    found = in_range & (index_hashes[safe] == query_hashes)
    return jnp.where(found, pos, -1).astype(jnp.int64)


def split_hash_u64(hashes):
    """Split a sorted uint64 hash array into (hi32, lo32) uint32 planes
    for the 32-bit lookup below (host-side helper; do once per index)."""
    import numpy as np

    h = np.asarray(hashes, dtype=np.uint64)
    return (h >> np.uint64(32)).astype(np.uint32), h.astype(np.uint32)


@functools.partial(jax.jit, static_argnames=("bits", "iters"))
def index_find_device_split(hi, lo, bucket_starts, bits: int, khi, klo,
                            iters: int = 18):
    """Batched StrobemerIndex.find in PURE 32-bit arithmetic.

    The u64 `jnp.searchsorted` in `index_find_device` is emulated on
    backends without native 64-bit compares (every compare lowers to
    multi-op 32-bit sequences); this variant stores the
    sorted hashes as (hi32, lo32) planes and runs a bucket-bounded
    per-query binary search with unsigned-32 lexicographic compares —
    int32 gathers and compares only. `iters` must cover the largest
    bucket (2^18 entries is far beyond any real filter profile; the
    search is correct as long as 2^iters >= max bucket run length).

    Returns first-occurrence positions (int64, -1 = absent), exactly
    `index_find_device` (including the bucket-table quirk)."""
    n = hi.shape[0]
    # unsigned 32-bit compare via sign-bit flip + signed compare
    sbit = jnp.uint32(0x80000000)
    his = (hi ^ sbit).astype(jnp.int32)
    los = (lo ^ sbit).astype(jnp.int32)
    qhi = (khi ^ sbit).astype(jnp.int32)
    qlo = (klo ^ sbit).astype(jnp.int32)

    top = (khi >> (jnp.uint32(32) - jnp.uint32(bits))).astype(jnp.int64)
    lo_b = bucket_starts[top].astype(jnp.int32)
    hi_b = bucket_starts[top + 1].astype(jnp.int32)

    def body(_, lohi):
        lo_i, hi_i = lohi
        mid = (lo_i + hi_i) >> 1
        safe = jnp.minimum(mid, n - 1)
        mh = his[safe]
        ml = los[safe]
        less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
        active = lo_i < hi_i
        lo_n = jnp.where(active & less, mid + 1, lo_i)
        hi_n = jnp.where(active & ~less, mid, hi_i)
        return (lo_n, hi_n)

    lo_f, _ = jax.lax.fori_loop(0, iters, body, (lo_b, hi_b))
    pos = lo_f
    in_range = (pos >= lo_b) & (pos < hi_b) & (pos < n)
    safe = jnp.minimum(jnp.where(pos < n, pos, 0), n - 1)
    found = in_range & (hi[safe] == khi) & (lo[safe] == klo)
    return jnp.where(found, pos.astype(jnp.int64), -1)


@functools.partial(jax.jit, static_argnames=("bits", "iters", "G"))
def index_find_device_gary(hi, lo, bucket_starts, bits: int, khi, klo,
                           iters: int, G: int = 16):
    """Batched StrobemerIndex.find via G-ary search + one slice gather.

    The binary search in `index_find_device_split` is gather-latency
    bound: ~20 serial data-dependent device-memory accesses. This variant
    cuts the serial depth to
    ceil(log_G(max_bucket_run)) + 1:

    * each narrowing step probes G-1 equally-strided positions in ONE
      parallel gather (all probes issue together, so a step costs one
      round-trip regardless of G) and keeps the segment whose bounds
      bracket the query — range shrinks by G per step, not 2;
    * the final step gathers G CONTIGUOUS entries (a vmapped
      dynamic_slice lowers to a single gather with slice_sizes=(G,))
      and picks the first >= query with vector compares only.

    Requirements: `hi`/`lo` are the split planes PADDED with >= G
    sentinel 0xFFFFFFFF entries (so the final dynamic_slice never
    clamps). `n` below treats exactly G rows as padding; with a larger
    pad the extra rows are counted as in-array, which is still correct
    BECAUSE every pad row is a 0xFFFFFFFF sentinel: it compares as +inf
    in the narrowing probes, and a false equality is excluded by the
    `pos < hi_b` bucket bound (hi_b <= logical n). `iters` must satisfy:
    w = max bucket run length, then ceil-divide by G `iters` times
    reaches <= G-1 (host-side helper `gary_iters`).

    Returns first-occurrence positions (int64, -1 = absent), exactly
    `index_find_device` / `_split` (including the bucket-table quirk).
    Semantics matched: /root/reference/src/index.hpp:57-81."""
    n = hi.shape[0] - G  # logical length (G sentinel pad rows)
    sbit = jnp.uint32(0x80000000)
    his = (hi ^ sbit).astype(jnp.int32)
    los = (lo ^ sbit).astype(jnp.int32)
    qhi = (khi ^ sbit).astype(jnp.int32)
    qlo = (klo ^ sbit).astype(jnp.int32)
    qshape = khi.shape
    qhi_f = qhi.reshape(-1)
    qlo_f = qlo.reshape(-1)

    top = (khi >> (jnp.uint32(32) - jnp.uint32(bits))).astype(jnp.int64)
    lo_b = bucket_starts[top].astype(jnp.int32).reshape(-1)
    hi_b = bucket_starts[top + 1].astype(jnp.int32).reshape(-1)

    # invariant: insertion point P in [lo_i, lo_i + width] (CLOSED upper
    # bound; the G-ary step preserves it with new width = stride)
    lo_i = lo_b
    width = hi_b - lo_b
    j_probe = jnp.arange(1, G, dtype=jnp.int32)  # (G-1,)
    imax = jnp.int32(0x7FFFFFFF)
    for _ in range(iters):
        stride = (width + (G - 1)) // G  # ceil(width / G)
        p = lo_i[:, None] + j_probe[None, :] * stride[:, None]
        safe = jnp.minimum(p, n - 1)
        vh = his[safe]
        vl = los[safe]
        # positions past the logical end compare as +inf
        oob = p >= n
        vh = jnp.where(oob, imax, vh)
        vl = jnp.where(oob, imax, vl)
        less = (vh < qhi_f[:, None]) | ((vh == qhi_f[:, None])
                                       & (vl < qlo_f[:, None]))
        j_sel = jnp.sum(less.astype(jnp.int32), axis=1)
        lo_i = lo_i + j_sel * stride
        width = stride

    # final: G contiguous entries starting at lo_i (padded planes, so no
    # dynamic_slice clamping for lo_i <= n); first j <= width with
    # value >= query, default width
    def slc(arr, s):
        return jax.lax.dynamic_slice(arr, (s,), (G,))

    vh = jax.vmap(slc, in_axes=(None, 0))(his, lo_i)
    vl = jax.vmap(slc, in_axes=(None, 0))(los, lo_i)
    ge = (vh > qhi_f[:, None]) | ((vh == qhi_f[:, None])
                                 & (vl >= qlo_f[:, None]))
    j = jnp.arange(G, dtype=jnp.int32)[None, :]
    cand = jnp.where(ge & (j <= width[:, None]), j, width[:, None])
    pos = lo_i + jnp.min(cand, axis=1)

    in_range = (pos >= lo_b) & (pos < hi_b) & (pos < n)
    safe = jnp.minimum(jnp.where(pos < n, pos, 0), n - 1)
    found = (in_range & (hi[safe] == khi.reshape(-1))
             & (lo[safe] == klo.reshape(-1)))
    return jnp.where(found, pos.astype(jnp.int64), -1).reshape(qshape)


def gary_iters(bucket_starts, G: int = 16) -> int:
    """Host-side: narrowing steps `index_find_device_gary` needs so the
    final G-slice covers the largest bucket run."""
    import numpy as np

    runs = np.diff(np.asarray(bucket_starts, dtype=np.int64))
    w = int(runs.max()) if runs.size else 0
    iters = 0
    while w > G - 1:
        w = -(-w // G)
        iters += 1
    return iters


# --- fully-vectorized variant (no lax.scan) -------------------------------
#
# The scan automaton above is the bit-exact reference implementation; this
# variant restructures the same computation into pure data-parallel ops
# (unrolled polynomial s-mer/k-mer evaluation, window min + argmin,
# searchsorted-free compaction, masked window linking), which accelerators
# run far faster than the sequential scan. One semantic caveat: the reference's min-queue breaks ties
# between EQUAL minimum s-mer hashes path-dependently (leftmost on first
# fill, rightmost after a slide-out eviction, keep-old on ties), which a
# per-window closed form cannot reproduce. Reads containing any window
# with a duplicated minimum get `tie=True` and must take the host (or
# scan) path; on random genomes that is ~0 reads, on unit repeats a few
# percent.

@functools.partial(jax.jit,
                   static_argnames=("k", "s", "t", "w_min", "w_max",
                                    "max_dist", "M"))
def randstrobes_query_vec(codes, lengths, k: int, s: int, t: int,
                          w_min: int, w_max: int, q: int, max_dist: int,
                          M: int):
    """Vectorized batched query randstrobes for both strands.

    codes (B, L) uint8 {0..3, 4=N}; lengths (B,) int32. Returns
    (hash (B, 2M) uint64, start (B, 2M) int32, end (B, 2M) int32,
    n_fwd (B,), n_rc (B,), tie (B,) bool); slots [0, n_fwd) and
    [M, M + n_rc) are valid; `tie` rows must be recomputed on the host.
    Requires s <= 32 and k <= 32 (the production profiles)."""
    B, L = codes.shape
    w = k - s + 1
    c64 = codes.astype(jnp.uint64)
    four = jnp.uint64(4)

    ns = L - s + 1
    fs = jnp.zeros((B, ns), jnp.uint64)
    rs = jnp.zeros((B, ns), jnp.uint64)
    for j in range(s):  # unrolled: no cross-position dependency
        cj = c64[:, j : j + ns]
        fs = fs * four + cj
        rs = rs + ((jnp.uint64(3) - cj) << jnp.uint64(2 * j))
    shash = xxh64_u64(jnp.minimum(fs, rs))

    nk = L - k + 1
    fk = jnp.zeros((B, nk), jnp.uint64)
    rk = jnp.zeros((B, nk), jnp.uint64)
    for j in range(k):
        cj = c64[:, j : j + nk]
        fk = fk * four + cj
        rk = rk + ((jnp.uint64(3) - cj) << jnp.uint64(2 * j))
    khash = xxh64_u64(jnp.minimum(fk, rk))

    # N gates: a window participates only when N-free (the automaton's
    # run-length counter)
    isn = codes >= 4
    csp = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(isn.astype(jnp.int32), axis=1)],
        axis=1,
    )
    sclean = (csp[:, s : s + ns] - csp[:, :ns]) == 0
    kclean = (csp[:, k : k + nk] - csp[:, :nk]) == 0
    inlen = (jnp.arange(nk, dtype=jnp.int32)[None, :] + k) <= lengths[:, None]

    sh = jnp.where(sclean, shash, UMAX)
    stack = jnp.stack([sh[:, j : j + nk] for j in range(w)], axis=0)  # (w,B,nk)
    mn = jnp.min(stack, axis=0)
    eq = stack == mn[None]
    arg = jnp.argmax(eq, axis=0)  # leftmost minimum
    ndup = jnp.sum(eq.astype(jnp.int32), axis=0)
    gate = kclean & inlen & (mn != UMAX)
    # the automaton tracks s-mer START positions; emission at offset t-1
    emit = gate & (arg.astype(jnp.int32) == t - 1)
    tie = jnp.any(gate & (ndup > 1), axis=1) | (
        jnp.sum(emit.astype(jnp.int32), axis=1) > M
    )

    # compact emissions into M slots (broadcast argmax instead of a
    # vmapped searchsorted, which can lower to per-element loops)
    ce = jnp.cumsum(emit.astype(jnp.int32), axis=1)
    n_sync = jnp.where(lengths >= w_max, ce[:, -1], 0)
    targets = jnp.arange(1, M + 1, dtype=jnp.int32)
    slot_pos = jnp.argmax(ce[:, None, :] >= targets[None, :, None],
                          axis=2).astype(jnp.int32)
    sync_pos = slot_pos
    sync_hash = jnp.take_along_axis(khash, slot_pos.astype(jnp.int64), axis=1)

    qmask = jnp.uint64(q)

    # packed tie key = popcount * mult + window offset: mult must exceed
    # the window width or a low-popcount candidate at a high offset
    # collides with the next popcount class (reachable with custom -l/-u
    # giving u - l >= 16) and the argmin diverges from the host's
    # leftmost-min rule
    key_mult = 1
    while key_mult < (w_max - w_min + 1):
        key_mult *= 2

    def link(pos, hsh, n):
        res_h = jnp.zeros((B, M), jnp.uint64)
        res_e = jnp.zeros((B, M), jnp.int32)
        best_key = jnp.full((B, M), 0x7FFFFFFF, jnp.int32)
        midx = jnp.arange(M, dtype=jnp.int32)[None, :]
        for d in range(w_min, w_max + 1):
            jpos = jnp.roll(pos, -d, axis=1)
            jh = jnp.roll(hsh, -d, axis=1)
            ok = (midx + d < n[:, None]) & (jpos <= pos + max_dist)
            pc = jax.lax.population_count((hsh ^ jh) & qmask).astype(jnp.int32)
            key = jnp.where(ok, pc * key_mult + (d - w_min), 0x7FFFFFFF)
            upd = key < best_key
            best_key = jnp.where(upd, key, best_key)
            res_h = jnp.where(upd, hsh + jh, res_h)
            res_e = jnp.where(upd, jpos, res_e)
        none = best_key == 0x7FFFFFFF  # no in-range strobe2: self-link
        res_h = jnp.where(none, hsh + hsh, res_h)
        res_e = jnp.where(none, pos, res_e)
        valid = (midx + w_min) < n[:, None]
        return res_h, pos, res_e, valid

    fh, f1, f2, fvalid = link(sync_pos, sync_hash, n_sync)

    rev_idx = jnp.clip(
        n_sync[:, None] - 1 - jnp.arange(M, dtype=jnp.int32)[None, :], 0, M - 1
    ).astype(jnp.int64)
    rpos = lengths[:, None] - jnp.take_along_axis(sync_pos, rev_idx.astype(jnp.int32), axis=1) - k
    rhsh = jnp.take_along_axis(sync_hash, rev_idx, axis=1)
    bh, b1, b2, bvalid = link(rpos, rhsh, n_sync)

    n_fwd = jnp.sum(fvalid.astype(jnp.int32), axis=1)
    n_rc = jnp.sum(bvalid.astype(jnp.int32), axis=1)
    return (
        jnp.concatenate([fh, bh], axis=1),
        jnp.concatenate([f1, b1], axis=1),
        jnp.concatenate([f2 + k, b2 + k], axis=1),
        n_fwd,
        n_rc,
        tie,
    )


@functools.partial(jax.jit,
                   static_argnames=("k", "s", "t", "w_min", "w_max", "q",
                                    "max_dist", "M", "bits"))
def seed_and_find(codes, lengths, index_hashes, bucket_starts,
                  k: int, s: int, t: int, w_min: int, w_max: int, q: int,
                  max_dist: int, M: int, bits: int):
    """One-dispatch device seeding + index lookup (--device-seed):
    vectorized randstrobes for both strands followed by the batched
    bucket-bound index find against the device-resident hash arrays.

    Returns (hash (B, 2M) u64, start (B, 2M) i32, end (B, 2M) i32,
    n_fwd (B,), n_rc (B,), tie (B,) bool, pos (B, 2M) i64). Valid slots
    are [0, n_fwd) and [M, M + n_rc); `tie` rows need the host path.

    This is the seeding offload behind `--device-seed`; whether it beats
    host seeding on the GPU is not measured yet (ROADMAP)."""
    h, st, en, nf, nr, tie = randstrobes_query_vec(
        codes, lengths, k, s, t, w_min, w_max, q, max_dist, M
    )
    pos = index_find_device(
        index_hashes, bucket_starts, jnp.uint64(bits), h
    )
    return h, st, en, nf, nr, tie, pos
