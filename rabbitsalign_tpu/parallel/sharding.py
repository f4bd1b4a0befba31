"""Multi-chip scaling over a jax.sharding.Mesh.

The reference is single-node threads + one GPU (SURVEY.md §2.7: no
distributed backend). The scaling design introduced here:

* **Data parallelism over reads** ('dp' mesh axis): each chip processes a
  shard of the extension batch — the analog of the reference's N worker
  threads over read chunks (src/main.cpp:453-592).
* **Replicated index** (small genomes): every chip holds the full
  hash-sorted randstrobe arrays, like the reference's per-NUMA-node index
  replicas (src/main.cpp:342-360); lookups are local gathers.
* **Sharded index** (whole-genome): `ShardedIndex` splits the
  hash-sorted arrays into contiguous hash ranges — aligned to equal-hash
  run boundaries, so every run lives on exactly one chip — and evaluates
  the reference's FULL lookup semantics per shard: first-occurrence
  position, equal-hash count, the repetitive filter, and the run's
  (position, packed) records (what `add_to_hits_per_ref` walks,
  reference src/nam.cpp:68-85, src/index.hpp:57-147). Off-shard results
  are zero, so a psum over the mesh combines them; candidate routing
  rides device collectives instead of host gathers. `chain/sharded_nams.py`
  builds NAMs from these prefetched runs, byte-equal to the host path.
* **Stats reduction**: per-chip AlignmentStatistics psum — the analog of
  summing per-thread stats at exit (src/main.cpp:597-615).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_bounds(hashes: np.ndarray, n_shards: int) -> np.ndarray:
    """Run-aligned contiguous cut points into the hash-sorted arrays:
    n_shards+1 bounds, each cut moved DOWN to the first entry of its
    equal-hash run so no run straddles two shards. The SINGLE source of
    the ownership rule — the device tier (`shard_index_by_hash`) and the
    cross-host pod tier (`multihost.PodShardedIndex`) must agree on who
    owns a hash, so both call this."""
    n = hashes.shape[0]
    if n == 0:
        return np.zeros(n_shards + 1, dtype=np.int64)
    ideal = (np.arange(1, n_shards) * n) // n_shards
    cuts = np.searchsorted(hashes, hashes[np.minimum(ideal, n - 1)],
                           side="left")
    return np.concatenate([[0], cuts, [n]]).astype(np.int64)


def shard_index_by_hash(hashes: np.ndarray, positions: np.ndarray, packed: np.ndarray,
                        n_shards: int, reachable: Optional[np.ndarray] = None):
    """Split the hash-sorted randstrobe arrays into n contiguous shards
    whose cuts are moved DOWN to equal-hash run starts, so no run ever
    straddles two shards (a query hash then belongs to exactly one shard
    and per-shard counts/runs are globally correct). Shards are padded to
    a common width with the 0xFF..F sentinel hash (which, like the
    reference's guard entry, can shadow a genuine all-ones hash — a
    ~1/2^64 event the reference accepts too).

    Returns (hashes (n, m), positions (n, m), packed (n, m),
    reachable (n, m) u8, shard_starts (n,))."""
    n = hashes.shape[0]
    if reachable is None:
        reachable = np.ones(n, dtype=np.uint8)
    bounds = shard_bounds(hashes, n_shards)
    m = int(np.max(np.diff(bounds))) if n else 1
    h = np.full((n_shards, m), SENTINEL, dtype=np.uint64)
    p = np.zeros((n_shards, m), dtype=positions.dtype)
    k = np.zeros((n_shards, m), dtype=packed.dtype)
    r = np.zeros((n_shards, m), dtype=np.uint8)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        h[s, : hi - lo] = hashes[lo:hi]
        p[s, : hi - lo] = positions[lo:hi]
        k[s, : hi - lo] = packed[lo:hi]
        r[s, : hi - lo] = reachable[lo:hi]
    return h, p, k, r, bounds[:-1].astype(np.int64)


def _bucket_reachable(index) -> np.ndarray:
    """Per-entry flag: would StrobemerIndex.find locate this entry's run?

    The reference's bucket table has a quirk (its first bucket does not
    cover the run of the globally smallest hash; see
    StrobemerIndex.find/_build_buckets), so exact-parity lookups must
    reject entries whose run start falls outside its bucket's range."""
    hashes = index.hashes
    n = hashes.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    first = np.searchsorted(hashes, hashes, side="left")
    tops = (hashes >> np.uint64(64 - index.bits)).astype(np.int64)
    lo = index.randstrobe_start_indices[tops].astype(np.int64)
    hi = index.randstrobe_start_indices[tops + 1].astype(np.int64)
    return ((first >= lo) & (first < hi)).astype(np.uint8)


class ShardedIndex:
    """The strobemer index hash-sharded across a device mesh with the
    full `StrobemerIndex::find` lookup semantics evaluated on-device.

    This is the whole-genome scale-out design the reference lacks: each
    chip stores 1/n of the hash-sorted arrays; a lookup batch is
    replicated to all chips, each searches its shard (binary search +
    run gather, zeros off-shard), and a psum combines the answers."""

    def __init__(self, mesh: Mesh, index, n_shards: Optional[int] = None):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        n_shards = n_shards or mesh.devices.size
        if n_shards != mesh.devices.size:
            # the shard_map locals read exactly one shard row each
            # (h_sh[0]); several shards per device would be silently
            # dropped from every lookup
            raise ValueError(
                f"n_shards ({n_shards}) must equal the mesh size "
                f"({mesh.devices.size}): one shard per device")
        h, p, k, r, starts = shard_index_by_hash(
            index.hashes, index.positions, index.packed, n_shards,
            _bucket_reachable(index),
        )
        sh2 = NamedSharding(mesh, P(self.axis, None))
        sh1 = NamedSharding(mesh, P(self.axis))
        self.hashes = jax.device_put(h, sh2)
        self.positions = jax.device_put(p, sh2)
        self.packed = jax.device_put(k, sh2)
        self.reachable = jax.device_put(r, sh2)
        self.starts = jax.device_put(starts, sh1)
        self.filter_cutoff = int(index.filter_cutoff)
        self._k = index.k()
        self._find = {}  # compiled lookup program per cap
        self._find_routed = {}  # compiled routed program per (cap, width)
        self.n_shards = int(n_shards)
        # host routing table: shard s owns keys in
        # [start_hash[s], start_hash[s+1]) — runs never straddle cuts, so
        # ownership is unique. An empty shard shares its successor's
        # start hash; searchsorted(side="right") then routes past it.
        n = index.hashes.shape[0]
        sh = np.full(n_shards, SENTINEL, dtype=np.uint64)
        for s in range(n_shards):
            if starts[s] < n:
                sh[s] = index.hashes[starts[s]]
        self._start_hash = sh
        # Defensive: route only to non-empty shards. By construction the
        # current cut rule cannot leave a TRAILING shard empty (cuts are
        # run starts, always < n) and side="right" already routes a tied
        # key past middle empties to the real owner — but the routed
        # lookup's correctness should not hinge on that cut-rule detail,
        # and 0xFFFF...F is both a legal hash and the empty-shard marker.
        ends = np.concatenate([starts[1:], [n]])
        nonempty = starts < ends
        self._route_nonempty = np.maximum.accumulate(
            np.where(nonempty, np.arange(n_shards), 0))

    def k(self) -> int:
        return self._k

    def find_runs(self, keys: np.ndarray, cap: int):
        """Full distributed lookup for a batch of query hashes.

        Returns a dict of numpy arrays:
          position  (NQ,)  int64  — global first-occurrence index, -1 if
                                    absent (== StrobemerIndex.find)
          count     (NQ,)  int64  — equal-hash run length
                                    (== get_count at that position)
          filtered  (NQ,)  bool   — count > filter_cutoff
                                    (== is_filtered at that position)
          run_positions (NQ, cap) uint32 — the run's strobe1 positions
          run_packed    (NQ, cap) uint32 — the run's (ref_id<<8|offset)
        Run rows beyond min(count, cap) are zero; callers that may walk
        runs longer than `cap` must re-fetch with a larger cap (find_nams
        only walks unfiltered runs, so cap=filter_cutoff is exact)."""
        fn = self._find.get(cap)
        if fn is None:
            fn = self._find[cap] = self._build(cap)
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        found_n, gpos, count, runp, runk = fn(
            self.hashes, self.positions, self.packed, self.reachable,
            self.starts, keys,
        )
        found = np.asarray(found_n) > 0
        return {
            "position": np.where(found, np.asarray(gpos), -1).astype(np.int64),
            "count": np.asarray(count).astype(np.int64),
            "filtered": np.asarray(count).astype(np.int64) > self.filter_cutoff,
            "run_positions": np.asarray(runp),
            "run_packed": np.asarray(runk),
        }

    def find_runs_routed(self, keys: np.ndarray, cap: int):
        """`find_runs` with host-side hash routing instead of the dense
        psum: each key is sent ONLY to its owning shard (contiguous hash
        ranges make ownership unique and host-computable), each chip
        looks up its own (width,) slice, and results come back sharded —
        no collective at all. The psum variant replicates the full query
        batch to every chip and all-reduces dense (NQ, cap) run
        matrices, i.e. ~(8*cap + 24) bytes/key of ring traffic per chip;
        the routed variant moves (8 + 8*cap + 24)/n_shards bytes/key
        over host<->device links and ZERO between devices. On a multi-host pod
        the per-host batch routes to local chips the same way; only keys
        owned by remote hosts' shards need a cross-host exchange (an
        all_to_all of ~NQ/n keys), which this single-host code path does
        not need."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        nq = keys.shape[0]
        ns = self.n_shards
        owner = np.searchsorted(self._start_hash, keys, side="right") - 1
        np.clip(owner, 0, ns - 1, out=owner)
        owner = self._route_nonempty[owner]  # never route to an empty shard
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=ns)
        width = int(counts.max()) if nq else 1
        # pow-2 width quantization bounds the compile count
        w = 8
        while w < width:
            w *= 2
        qmat = np.full((ns, w), 0, dtype=np.uint64)
        slot = np.empty(nq, dtype=np.int64)
        offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
        pos_in_shard = np.arange(nq) - offs[owner[order]]
        qmat[owner[order], pos_in_shard] = keys[order]
        slot[order] = owner[order] * w + pos_in_shard
        fn = self._find_routed.get((cap, w))
        if fn is None:
            fn = self._find_routed[(cap, w)] = self._build_routed(cap)
        found_n, gpos, count, runp, runk = fn(
            self.hashes, self.positions, self.packed, self.reachable,
            self.starts, qmat,
        )
        flat = lambda a: np.asarray(a).reshape(ns * w, *a.shape[2:])
        found = flat(found_n)[slot] > 0
        count_o = flat(count)[slot]
        return {
            "position": np.where(found, flat(gpos)[slot], -1).astype(np.int64),
            "count": count_o.astype(np.int64),
            "filtered": count_o.astype(np.int64) > self.filter_cutoff,
            "run_positions": flat(runp)[slot],
            "run_packed": flat(runk)[slot],
        }

    def _build_routed(self, cap: int):
        def local(h_sh, p_sh, k_sh, r_sh, start, q_sh):
            h = h_sh[0]
            pos_arr = p_sh[0]
            pk_arr = k_sh[0]
            reach = r_sh[0]
            q = q_sh[0]
            m = h.shape[0]
            lo = jnp.searchsorted(h, q, side="left")
            hi = jnp.searchsorted(h, q, side="right")
            in_r = lo < m
            safe = jnp.where(in_r, lo, 0)
            found = in_r & (h[safe] == q) & (reach[safe] > 0)
            count = jnp.where(found, hi - lo, 0)
            rows = jnp.arange(cap)
            idx = jnp.minimum(safe[:, None] + rows[None, :], m - 1)
            valid = found[:, None] & (rows[None, :] < count[:, None])
            runp = jnp.where(valid, pos_arr[idx], 0)
            runk = jnp.where(valid, pk_arr[idx], 0)
            gpos = jnp.where(found, lo + start[0], 0)
            return (found.astype(jnp.int32)[None], gpos.astype(jnp.int64)[None],
                    count.astype(jnp.int64)[None], runp[None], runk[None])

        return jax.jit(jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(self.axis, None), P(self.axis, None),
                      P(self.axis, None), P(self.axis, None),
                      P(self.axis), P(self.axis, None)),
            out_specs=(P(self.axis, None), P(self.axis, None),
                       P(self.axis, None), P(self.axis, None, None),
                       P(self.axis, None, None)),
        ))

    def _build(self, cap: int):
        axis = self.axis

        def local(h_sh, p_sh, k_sh, r_sh, start, q):
            h = h_sh[0]
            pos_arr = p_sh[0]
            pk_arr = k_sh[0]
            reach = r_sh[0]
            m = h.shape[0]
            lo = jnp.searchsorted(h, q, side="left")
            hi = jnp.searchsorted(h, q, side="right")
            in_r = lo < m
            safe = jnp.where(in_r, lo, 0)
            found = in_r & (h[safe] == q) & (reach[safe] > 0)
            count = jnp.where(found, hi - lo, 0)
            rows = jnp.arange(cap)
            idx = jnp.minimum(safe[:, None] + rows[None, :], m - 1)
            valid = found[:, None] & (rows[None, :] < count[:, None])
            runp = jnp.where(valid, pos_arr[idx], 0)
            runk = jnp.where(valid, pk_arr[idx], 0)
            gpos = jnp.where(found, lo + start[0], 0)
            return (
                jax.lax.psum(found.astype(jnp.int32), axis),
                jax.lax.psum(gpos.astype(jnp.int64), axis),
                jax.lax.psum(count.astype(jnp.int64), axis),
                jax.lax.psum(runp, axis),
                jax.lax.psum(runk, axis),
            )

        return jax.jit(jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(self.axis, None), P(self.axis, None),
                      P(self.axis, None), P(self.axis, None),
                      P(self.axis), P()),
            out_specs=(P(), P(), P(), P(), P()),
        ))


def sharded_find(mesh: Mesh, index, queries, cap: Optional[int] = None):
    """Distributed StrobemerIndex.find over a mesh (convenience wrapper
    around ShardedIndex for one-off lookups): returns global
    first-occurrence positions (int64, -1 if absent), matching
    StrobemerIndex.find including the bucket-table quirk."""
    si = ShardedIndex(mesh, index)
    return si.find_runs(queries, cap or max(1, si.filter_cutoff))["position"]


def data_parallel_extend(mesh: Mesh, params, q_codes, t_codes, qlen, tlen):
    """Data-parallel batched extension: batch dimension sharded over the
    mesh, each chip runs the wavefront DP on its shard, per-chip stats are
    psum'd. Uses the lax.scan forward pass (sw_jax) so it runs on any
    mesh, CPU included.

    Returns (score, t_end, q_end, total_cells) with score/... sharded
    like the inputs and total_cells replicated.
    """
    from ..ops.sw_jax import sw_forward

    axis = mesh.axis_names[0]

    def step(q, t, ql, tl):
        score, t_end, q_end, _ = sw_forward(q, t, ql, tl, params, with_dirs=False)
        cells = jax.lax.psum(jnp.sum(ql.astype(jnp.int64) * tl.astype(jnp.int64)), axis)
        return score, t_end, q_end, cells

    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P()),
    )(q_codes, t_codes, qlen, tlen)
