"""Multi-host data-parallel mapping over jax.distributed.

The reference has no distributed layer (single process + one GPU,
reference src/pc.cpp); this is this repo's scale-out design
(SURVEY.md §2.7): every host runs the same binary, `jax.distributed`
forms the pod, read chunks are sharded across hosts by chunk index
(round-robin, so no coordination is needed beyond the deterministic
chunk numbering the ordered output already relies on), each host maps
its shard with its local chips through the normal NativePipeline /
ThreadedNativePipeline, writes a per-host output shard, and global
statistics reduce with a psum over the pod mesh.

Output merging: per-host files named ``<out>.part<P>of<N>`` interleave
by chunk index; `merge_output` concatenates them in chunk order (each
part records its chunk indices in a sidecar). For SAM the header is
written only by host 0.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize jax.distributed (no-op for a single process) and return
    (process_index, process_count)."""
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()  # env-configured pod
    return jax.process_index(), jax.process_count()


def shard_chunks(
    chunks: Iterable, process_index: int, process_count: int
) -> Iterable:
    """Round-robin chunk sharding by chunk index: host p maps chunks with
    index % process_count == p. Every host reads the input stream (cheap
    relative to mapping; index parsing is sequential) but only seeds and
    aligns its own shard."""
    for item in chunks:
        chunk_index = item[0]
        if chunk_index % process_count == process_index:
            yield item


class ShardWriter:
    """Writes one host's output shard plus a chunk-index manifest so the
    shards can be merged back into global chunk order."""

    def __init__(self, base_path: str, process_index: int, process_count: int):
        self.process_count = process_count
        self.process_index = process_index
        if process_count == 1:
            self.path = base_path
        else:
            self.path = f"{base_path}.part{process_index}of{process_count}"
        self._f = open(self.path, "wb")
        self._manifest: List[Tuple[int, int]] = []  # (chunk_index, n_bytes)

    def write_chunk(self, chunk_index: int, text) -> None:
        data = text if isinstance(text, bytes) else text.encode()
        self._f.write(data)
        self._manifest.append((chunk_index, len(data)))

    def close(self) -> None:
        self._f.close()
        if self.process_count > 1:
            with open(self.path + ".manifest", "w") as m:
                json.dump(self._manifest, m)


def merge_output(base_path: str, process_count: int, header: str = "") -> None:
    """Merge per-host shards into `base_path` in global chunk order."""
    parts = []
    for p in range(process_count):
        path = f"{base_path}.part{p}of{process_count}"
        with open(path + ".manifest") as m:
            manifest = json.load(m)
        offsets = []
        off = 0
        for chunk_index, n in manifest:
            offsets.append((chunk_index, off, n))
            off += n
        parts.append((path, offsets))
    entries = []
    for path, offsets in parts:
        for chunk_index, off, n in offsets:
            entries.append((chunk_index, path, off, n))
    entries.sort()
    with open(base_path, "wb") as out:
        if header:
            out.write(header.encode())
        handles = {path: open(path, "rb") for path, _ in parts}
        try:
            for _, path, off, n in entries:
                f = handles[path]
                f.seek(off)
                out.write(f.read(n))
        finally:
            for f in handles.values():
                f.close()


def psum_statistics(values: dict) -> dict:
    """Reduce per-host statistics across the pod with a psum over the
    global device mesh (the analog of summing per-thread stats at exit,
    reference src/main.cpp:597-615)."""
    import jax

    keys = sorted(values)
    local = np.array([float(values[k]) for k in keys], dtype=np.float64)
    if jax.process_count() == 1:
        return dict(values)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(local)
    total = np.asarray(gathered).reshape(jax.process_count(), -1).sum(axis=0)
    return {k: total[i] for i, k in enumerate(keys)}


class PodShardedIndex:
    """The strobemer index GENUINELY split across pod processes.

    Each host holds ONLY its contiguous, run-aligned slice of the
    hash-sorted randstrobe arrays (the same cut rule as
    `parallel.sharding.shard_index_by_hash`, so a query hash is owned by
    exactly one host); lookups route host-side by hash range, local keys
    resolve against the local slice, and remote-owned keys are SENT to
    the owning host over a persistent TCP side channel whose server
    thread answers from its slice. Request/response (not a lockstep
    collective) because the rescue preflight issues a data-dependent
    number of lookups per chunk — hosts must be free to call at
    different rates. Presents the `find_runs_routed` interface the
    --shard-index RunFeed path consumes, so phase A is unchanged.

    This is the whole-genome scale-out the blueprint demands (SURVEY
    §2.7; BASELINE config 5 "sharded GRCh38 index" past one host's
    memory); the reference has no analog (single process + NUMA
    replicas, src/main.cpp:325-360). Within one host the same ownership
    rule spans the devices via ShardedIndex; this class is the cross-HOST
    tier above it.
    """

    _HDR = "<qqq"  # nq, cap, opcode

    def __init__(self, index, process_index: int, process_count: int,
                 peers: List[str]):
        import socket
        import struct
        import threading

        hashes = index.hashes
        n = hashes.shape[0]
        from .sharding import _bucket_reachable, shard_bounds

        reachable = _bucket_reachable(index)
        bounds = shard_bounds(hashes, process_count)
        lo, hi = int(bounds[process_index]), int(bounds[process_index + 1])
        # this host's slice — genuine copies (np.ascontiguousarray on a
        # contiguous slice returns a VIEW keeping the full 12 GB array
        # alive; np.array(copy=True) detaches, so the caller can free
        # the full index and the memory split is real)
        self._h = np.array(hashes[lo:hi], dtype=np.uint64, copy=True)
        self._p = np.array(index.positions[lo:hi], dtype=np.uint32,
                           copy=True)
        self._k = np.array(index.packed[lo:hi], dtype=np.uint32, copy=True)
        self._r = np.array(reachable[lo:hi], dtype=np.uint8, copy=True)
        self._base = lo
        # slice-trimmed bucket table: the engine's 75 ns ix_find owes its
        # speed to the bucket narrowing; a flat searchsorted over the
        # slice costs several times the whole lookup. The slice covers a
        # contiguous top-bits range, so only
        # those buckets are kept (~(2^bits)/nprocs entries).
        bits = int(index.bits)
        self._bits = bits
        if hi > lo:
            top_lo = int(self._h[0]) >> (64 - bits)
            top_hi = int(self._h[-1]) >> (64 - bits)
        else:
            top_lo = top_hi = 0
        bt_full = index.randstrobe_start_indices
        bt = np.clip(np.asarray(bt_full[top_lo:top_hi + 2],
                                dtype=np.int64), lo, hi) - lo
        self._bt = bt
        self._top0 = top_lo
        run_max = int((bt[1:] - bt[:-1]).max()) if bt.shape[0] > 1 else 0
        self._iters = (max(1, int(np.ceil(np.log2(run_max + 1))) + 1)
                       if run_max > 0 else 1)
        # global routing table (tiny): owner s covers
        # [start_hash[s], start_hash[s+1])
        sh = np.full(process_count, np.uint64(0xFFFFFFFFFFFFFFFF),
                     dtype=np.uint64)
        for s in range(process_count):
            if bounds[s] < n:
                sh[s] = hashes[bounds[s]]
        ends = np.concatenate([bounds[1:], [n]])
        nonempty = bounds[:-1] < ends[: process_count]
        self._route_nonempty = np.maximum.accumulate(
            np.where(nonempty, np.arange(process_count), 0))
        self._start_hash = sh
        self.filter_cutoff = int(index.filter_cutoff)
        self._kparam = index.k()
        self.pid = process_index
        self.nprocs = process_count
        self._peers = peers
        self._struct = struct
        self._socket = socket
        self._conns = {}
        self._ever_connected = {}  # per-owner: fast redial after a death
        self._io_locks = {}
        self._conn_lock = threading.Lock()
        self._pool = None  # lazily-built remote fan-out executor
        # wire-traffic telemetry (per process; batch-granular, so the
        # lock is cold)
        self._stats_lock = threading.Lock()
        self.stats = {"lookup_batches": 0, "lookup_keys": 0,
                      "remote_batches": 0, "remote_keys": 0,
                      "tx_bytes": 0, "rx_bytes": 0}
        # server thread: answer lookups against the local slice
        host, port = peers[process_index].rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, int(port)))
        srv.listen(process_count)
        self._srv = srv
        t = threading.Thread(target=self._serve, daemon=True)
        t.start()

    def k(self) -> int:
        return self._kparam

    # --- local slice lookup (StrobemerIndex.find semantics) -----------

    def _lookup_sparse(self, keys: np.ndarray, cap: int):
        """Bucket-bounded vectorized lookup against the local slice.

        Returns (found u8, gpos i64, count i64, ent_p u32, ent_k u32)
        where ent_p/ent_k concatenate min(count, cap) run entries per
        FOUND key in key order — the sparse form that both the wire
        protocol and the dense edge consume. The binary searches run
        only inside the key's bucket run (self._bt narrows to ~2^-bits
        of the slice), with a fixed iteration count derived from the
        longest bucket, as a lock-step vector loop."""
        m = self._h.shape[0]
        nq = keys.shape[0]
        e0p = np.zeros(0, np.uint32)
        if m == 0 or nq == 0:
            # an empty slice can still be routed to (keys below the
            # smallest indexed hash route to shard 0 even when the
            # run-aligned cut left it empty); everything is a miss
            return (np.zeros(nq, np.uint8), np.zeros(nq, np.int64),
                    np.zeros(nq, np.int64), e0p, e0p)
        tops = (keys >> np.uint64(64 - self._bits)).astype(np.int64)
        tops -= self._top0
        np.clip(tops, 0, self._bt.shape[0] - 2, out=tops)
        blo = self._bt[tops]
        bhi = self._bt[tops + 1]
        mmax = m - 1

        def bound(cmp_lt):
            ll, rr = blo.copy(), bhi.copy()
            for _ in range(self._iters):
                active = ll < rr
                if not active.any():
                    break
                mid = (ll + rr) >> 1
                mv = self._h[np.minimum(mid, mmax)]
                go = active & cmp_lt(mv)
                ll = np.where(go, mid + 1, ll)
                rr = np.where(active & ~go, mid, rr)
            return ll

        lo = bound(lambda mv: mv < keys)
        hi = bound(lambda mv: mv <= keys)
        safe = np.minimum(lo, mmax)
        found = (lo < bhi) & (self._h[safe] == keys) & (self._r[safe] > 0)
        count = np.where(found, hi - lo, 0).astype(np.int64)
        gpos = np.where(found, lo + self._base, 0).astype(np.int64)
        cnt = np.minimum(count, cap)
        sel = np.flatnonzero(cnt > 0)
        if sel.size:
            c = cnt[sel]
            tot = int(c.sum())
            csum0 = np.concatenate(([0], np.cumsum(c)[:-1]))
            col = np.arange(tot, dtype=np.int64) - np.repeat(csum0, c)
            offs = np.repeat(lo[sel], c) + col
            ent_p = self._p[offs]
            ent_k = self._k[offs]
        else:
            ent_p = ent_k = e0p
        return (found.astype(np.uint8), gpos, count, ent_p, ent_k)

    @staticmethod
    def _densify(nq: int, cap: int, found, count, ent_p, ent_k,
                 runp=None, runk=None, rows_map=None):
        """Scatter sparse run entries into the dense (nq, cap) planes
        the RunFeed interface consumes. rows_map translates sparse row
        numbers to output rows (for remote-share scatter)."""
        if runp is None:
            runp = np.zeros((nq, cap), np.uint32)
            runk = np.zeros((nq, cap), np.uint32)
        cnt = np.minimum(np.where(found > 0, count, 0), cap)
        sel = np.flatnonzero(cnt > 0)
        if sel.size:
            c = cnt[sel]
            tot = int(c.sum())
            csum0 = np.concatenate(([0], np.cumsum(c)[:-1]))
            col = np.arange(tot, dtype=np.int64) - np.repeat(csum0, c)
            out_rows = sel if rows_map is None else rows_map[sel]
            runp[np.repeat(out_rows, c), col] = ent_p
            runk[np.repeat(out_rows, c), col] = ent_k
        return runp, runk


    # --- wire protocol --------------------------------------------------

    def _serve(self) -> None:
        import threading

        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _recv_exact(self, conn, nbytes: int) -> bytes:
        buf = bytearray()
        while len(buf) < nbytes:
            part = conn.recv(nbytes - len(buf))
            if not part:
                raise ConnectionError("pod lookup peer closed")
            buf += part
        return bytes(buf)

    def _serve_conn(self, conn) -> None:
        struct = self._struct
        hsz = struct.calcsize(self._HDR)
        try:
            while True:
                nq, cap, _op = struct.unpack(self._HDR,
                                             self._recv_exact(conn, hsz))
                keys = np.frombuffer(self._recv_exact(conn, 8 * nq),
                                     dtype=np.uint64)
                found, gpos, count, ent_p, ent_k = self._lookup_sparse(
                    keys, cap)
                # sparse response: run entries only for found keys
                # (min(count, cap) each, key order) — the dense form was
                # nq*cap*8 B ≈ 260 MB per 48k-read chunk at cap 30; the
                # sparse form carries only real entries
                conn.sendall(found.tobytes() + gpos.tobytes() +
                             count.tobytes() +
                             struct.pack("<q", ent_p.shape[0]) +
                             ent_p.tobytes() + ent_k.tobytes())
        except (ConnectionError, OSError):
            conn.close()
        except Exception:
            # never leave a requester stalled mid-frame on a server-side
            # bug: closing makes its recv raise ConnectionError instead
            # of timing out 120 s later
            conn.close()
            raise

    def _connect(self, owner: int):
        """Dial a peer, retrying connection refusal: pod hosts reach
        PodShardedIndex construction at very different times (GB-scale
        slice copies, mmap cold faults), so the fast host's first lookup
        can precede a slow host's server bind by minutes. Deadline via
        RSB_POD_CONNECT_TIMEOUT (seconds, default 600)."""
        import os
        import time

        host, port = self._peers[owner].rsplit(":", 1)
        budget = float(os.environ.get("RSB_POD_CONNECT_TIMEOUT", "600"))
        if self._ever_connected.get(owner):
            # this peer WAS up: a refused redial mid-run means it died,
            # not that it is still starting — fail fast (the caller holds
            # the per-owner io_lock; a 600 s loop here would stall every
            # worker thread's batches to this owner for 10 minutes each)
            budget = min(budget, float(
                os.environ.get("RSB_POD_REDIAL_TIMEOUT", "5")))
        deadline = time.monotonic() + budget
        while True:
            try:
                conn = self._socket.create_connection((host, int(port)),
                                                      timeout=120)
                self._ever_connected[owner] = True
                return conn
            except ConnectionRefusedError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    def _remote(self, owner: int, keys: np.ndarray, cap: int):
        import threading

        with self._conn_lock:
            io_lock = self._io_locks.setdefault(owner, threading.Lock())
        # the per-owner lock spans the WHOLE request/response exchange:
        # find_runs_routed must stay thread-safe (ShardedIndex's contract,
        # consumed by ThreadedNativePipeline), and two callers interleaving
        # frames on one socket would silently read each other's runs.
        # The connection is (re)resolved AFTER taking io_lock, so a thread
        # queued behind a failed exchange sees the eviction and redials
        # instead of writing to the dead socket; dialing holds only this
        # owner's lock, never the global _conn_lock (a slow peer must not
        # block other owners' exchanges or close()).
        with io_lock:
            for attempt in (0, 1):
                with self._conn_lock:
                    conn = self._conns.get(owner)
                if conn is None:
                    conn = self._connect(owner)
                    with self._conn_lock:
                        self._conns[owner] = conn
                try:
                    nq = keys.shape[0]
                    conn.sendall(self._struct.pack(self._HDR, nq, cap, 0)
                                 + keys.tobytes())
                    found = np.frombuffer(self._recv_exact(conn, nq),
                                          np.uint8)
                    gpos = np.frombuffer(self._recv_exact(conn, 8 * nq),
                                         np.int64)
                    count = np.frombuffer(self._recv_exact(conn, 8 * nq),
                                          np.int64)
                    (tot,) = self._struct.unpack(
                        "<q", self._recv_exact(conn, 8))
                    if not (0 <= tot <= nq * cap):
                        # a garbage entry count means the stream is
                        # desynced (mid-frame leftovers from a failed
                        # exchange): treat exactly like a socket error —
                        # evict + retry on a fresh connection — instead
                        # of letting recv(4*tot) raise Value/MemoryError
                        # past the except below and leave the poisoned
                        # socket cached for the NEXT batch to misparse
                        raise ConnectionError(
                            f"pod lookup response desynced (tot={tot}, "
                            f"nq={nq}, cap={cap})")
                    ent_p = np.frombuffer(self._recv_exact(conn, 4 * tot),
                                          np.uint32)
                    ent_k = np.frombuffer(self._recv_exact(conn, 4 * tot),
                                          np.uint32)
                    with self._stats_lock:
                        self.stats["remote_batches"] += 1
                        self.stats["remote_keys"] += nq
                        self.stats["tx_bytes"] += 24 + 8 * nq
                        self.stats["rx_bytes"] += 17 * nq + 8 + 8 * tot
                    return found, gpos, count, ent_p, ent_k
                except (ConnectionError, OSError):
                    # a failed exchange leaves the stream mid-frame: evict
                    # the socket (next lookup reconnects instead of parsing
                    # the desynced stream at wrong offsets) and retry ONCE
                    # on a fresh connection — one transient peer hiccup
                    # must not fail every in-flight lookup batch
                    self._evict(owner, conn)
                    if attempt:
                        raise
                except BaseException:
                    # any OTHER failure mid-exchange (Value/MemoryError
                    # from corrupt frames, KeyboardInterrupt, ...) leaves
                    # the stream equally desynced: evict before
                    # propagating so the next batch cannot misparse the
                    # leftovers as its own reply
                    self._evict(owner, conn)
                    raise

    def _evict(self, owner: int, conn) -> None:
        with self._conn_lock:
            if self._conns.get(owner) is conn:
                del self._conns[owner]
        try:
            conn.close()
        except OSError:
            pass

    def _fanout(self):
        """Lazily-built executor for the concurrent remote fan-out.

        Sized past (nprocs-1): per-owner exchanges serialize on io_lock
        anyway, but ThreadedNativePipeline can have several worker
        threads fanning out at once, and a pool worker parked on a busy
        owner's io_lock must not starve another owner's send."""
        with self._conn_lock:
            pool = self._pool
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(
                    max_workers=min(32, max(1, (self.nprocs - 1) * 4)),
                    thread_name_prefix="pod-fanout")
                self._pool = pool
        return pool

    # --- the find_runs interface ----------------------------------------

    def find_runs_routed(self, keys: np.ndarray, cap: int):
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        nq = keys.shape[0]
        with self._stats_lock:
            self.stats["lookup_batches"] += 1
            self.stats["lookup_keys"] += nq
        owner = np.searchsorted(self._start_hash, keys, side="right") - 1
        np.clip(owner, 0, self.nprocs - 1, out=owner)
        owner = self._route_nonempty[owner]
        found = np.zeros(nq, np.uint8)
        gpos = np.zeros(nq, np.int64)
        count = np.zeros(nq, np.int64)
        runp = np.zeros((nq, cap), np.uint32)
        runk = np.zeros((nq, cap), np.uint32)
        # remote owners are queried CONCURRENTLY (one pool task per owner,
        # submitted before the local lookup runs): an N-host pod pays ~1
        # round-trip per batch instead of N-1 sequential RTTs, and the
        # local slice lookup overlaps the wire wait
        pending = []
        for s in range(self.nprocs):
            if s == self.pid:
                continue
            sel = np.flatnonzero(owner == s)
            if sel.size == 0:
                continue
            ks = np.ascontiguousarray(keys[sel])
            pending.append((sel, self._fanout().submit(
                self._remote, s, ks, cap)))
        sel0 = np.flatnonzero(owner == self.pid)
        if sel0.size:
            part = self._lookup_sparse(keys[sel0], cap)
            found[sel0], gpos[sel0], count[sel0] = part[0], part[1], part[2]
            self._densify(nq, cap, part[0], part[2], part[3], part[4],
                          runp, runk, rows_map=sel0)
        for sel, fut in pending:
            part = fut.result()
            found[sel], gpos[sel], count[sel] = part[0], part[1], part[2]
            self._densify(nq, cap, part[0], part[2], part[3], part[4],
                          runp, runk, rows_map=sel)
        fb = found > 0
        return {
            "position": np.where(fb, gpos, -1).astype(np.int64),
            "count": count,
            "filtered": count > self.filter_cutoff,
            "run_positions": runp,
            "run_packed": runk,
        }

    find_runs = find_runs_routed

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conn_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        with self._conn_lock:
            for c in self._conns.values():
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()
