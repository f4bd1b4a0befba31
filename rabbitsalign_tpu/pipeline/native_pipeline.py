"""Production chunk pipeline around the native engine.

Drives the two-phase schedule of the reference's async workers
(/root/reference/src/pc.cpp:1206-1510): phase A of chunk i+1 (C++) runs
while the device extends chunk i's batches; phase B (C++) then finishes
chunk i. Device dispatch is asynchronous (jax) so the device works while
the host seeds.

When no device is used (``--no-tpu``) the engine's built-in SSW resolves
all gapped jobs natively.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Iterable, Tuple

import numpy as np

from ..native.engine import NativeEngine, engine_available

def boost_mapping_thread(level: int = -5) -> bool:
    """Renice the CALLING thread (Linux: setpriority with a tid applies
    per-thread) so phase A outranks the in-process jax client threads
    under CFS when they contend for cores; a -5 nice delta shifts the
    contended share toward the mapping threads WITHOUT starving the
    client (unlike SCHED_FIFO, which would stall uploads of the previous
    chunk for the whole phase-A burst). No-op without
    privileges or on non-Linux. ``RSB_RENICE=0`` disables, ``RSB_RENICE=n``
    overrides the level."""
    import os
    import threading

    env = os.environ.get("RSB_RENICE", "")
    if env == "0":
        return False
    if env:
        try:
            level = int(env)
        except ValueError:
            pass
    try:
        tid = threading.get_native_id()
        os.setpriority(os.PRIO_PROCESS, tid, level)
        return True
    except (AttributeError, PermissionError, OSError):
        return False


def pin_worker_thread(wid: int):
    """Pin the CALLING thread to one allowed CPU, round-robin by worker
    id — the analog of the reference's consumer-thread affinity
    (/root/reference/src/pc.cpp:519-527 pins worker i to core i). Keeps
    each worker's index/cache working set on one core and away from the
    jax client threads on many-core production hosts. Returns the cpu id, or
    None when pinning is unavailable (non-Linux, empty mask)."""
    import os

    try:
        allowed = sorted(os.sched_getaffinity(0))
        if not allowed:
            return None
        cpu = allowed[wid % len(allowed)]
        # pid 0 = the calling THREAD for sched_setaffinity on Linux
        os.sched_setaffinity(0, {cpu})
        return cpu
    except (AttributeError, OSError):
        return None


_RESIDENT_CACHE: dict = {}
_SEED_IX_CACHE: dict = {}  # (id(index), device) -> uploaded index arrays
_RESIDENT_LOCK = threading.Lock()


def _resident_ref_codes(references, engine, devices):
    # the lock matters: threaded workers construct their pipelines
    # concurrently, and pack_ref_pages + device_put release the GIL — an
    # unlocked miss path would upload N full genome copies and pin
    # N x genome-size device memory for the whole run
    key = id(references)
    with _RESIDENT_LOCK:
        cached = _RESIDENT_CACHE.get(key)
        if cached is not None and len(cached[1]) == len(devices):
            return cached[1]
        import jax

        from ..ops.extend_device import pack_ref_pages

        pages = pack_ref_pages(engine.ref_codes())
        arrs = [jax.device_put(pages, dev) for dev in devices]
        # keep a strong ref to `references` so the id() key stays valid
        _RESIDENT_CACHE.clear()  # one genome per run; no stale copies
        _RESIDENT_CACHE[key] = (references, arrs)
        return arrs


class NativePipeline:
    def __init__(
        self,
        index,
        index_parameters,
        references,
        aln_params,
        map_param,
        read_group_id: str = "",
        use_device: bool = True,
        batch_size: int = 1024,
        kernel=None,
        device_seed: bool = False,
        shard_index: bool = False,
        sharded_index=None,
        device_rr=None,
    ):
        self.engine = NativeEngine(
            index, index_parameters, references, aln_params, map_param,
            read_group_id,
        )
        self.batch_size = batch_size
        if use_device and aln_params.gap_extend >= aln_params.gap_open:
            # ssw.c's striped lazy-F pruning diverges from the device
            # kernel's textbook DP exactly when gap extension is as
            # cheap as opening (O == E; probed over 12k tie-dense pairs
            # — zero divergences at any O > E, see the align/ssw.py
            # module docstring). Host SSW keeps
            # byte-parity with the reference there; device dispatch
            # would not. E > O is rejected by the CLI already.
            from ..utils.logger import logger

            logger.info(
                "gap_extend >= gap_open: device extension disabled to "
                "preserve byte-parity with the reference's ssw semantics "
                "(host SSW resolves all gapped alignments)")
            use_device = False
        self.use_device = use_device
        # --shard-index: every index lookup served by the mesh-sharded
        # index (parallel/sharding.ShardedIndex) instead of host arrays;
        # phase A consumes prefetched run records (engine RunFeed). This
        # is the whole-genome scale-out path: with N chips each holds
        # 1/N of the hash-sorted arrays.
        self.shard_index = bool(shard_index)
        self._sharded = sharded_index
        self._map_param = map_param
        if self.shard_index and self._sharded is None:
            from ..parallel.sharding import ShardedIndex, make_mesh

            self._sharded = ShardedIndex(make_mesh(), index)
        # --device-seed: seeding + index find run on the accelerator
        # (ops/seed_device.seed_and_find); phase A consumes the preseed.
        # Off by default (ROADMAP: not yet measured against host seeding)
        self.device_seed = device_seed and use_device
        self._seed_ix = None
        self._params = index_parameters
        self._index = index
        self._sw = None
        self._devices = None
        self._next_dev = 0  # multi-device dispatches made by this pipeline
        # round-robin position over the devices; threaded workers share
        # one so a few dispatches per worker still cover every device
        self._device_rr = device_rr if device_rr is not None else itertools.count()
        self.device_pairs = 0  # pairs sent through _dispatch
        self.kernel = None
        if use_device:
            import jax

            from ..ops.extend_device import extend_program
            from ..ops.sw_jax import SwParams

            # kernel=None: the extend program of the observed platform
            # (ops/extend_device.extend_program); callers may pass another
            # program body to compare programs on one device
            self.kernel = kernel or extend_program(jax.devices()[0].platform)
            self._sw = SwParams(
                aln_params.match, aln_params.mismatch, aln_params.gap_open,
                aln_params.gap_extend,
            )
            # round-robin independent extend batches across all local
            # devices: data parallelism over the batch dimension needs no
            # collectives (each batch is self-contained), so this is the
            # natural multi-device mapping of the reference's GPU streams
            self._devices = jax.local_devices()
            # resident reference: the genome (nt4 codes) lives in each
            # device's memory for the whole run; per-batch uploads carry
            # only query codes + u32 target offsets (fill_batch_q2). One
            # copy per device per run, shared by all threaded workers.
            self._ref_codes = _resident_ref_codes(
                references, self.engine, self._devices
            )

    def _fill(self, chunk, idxs, B, Q, T):
        return self.engine.fill_batch_q2(chunk, idxs, B, Q)

    SEED_L = 256  # max read length seeded on device (longer -> host)

    def _preseed(self, fx, n_records, chunk_index):
        """Device seeding + index find for one reader chunk: returns the
        flat preseed arrays chunk_a_fx_pre consumes (counts[i] = -1 for
        reads the device path cannot do bit-exactly: too long, or a
        min-queue tie the closed-form kernel cannot break)."""
        import jax
        import numpy as np

        from ..ops.seed_device import seed_and_find

        if self._seed_ix is None:
            # shared across threaded workers (same pattern as the
            # resident genome): the hash array is GB-scale for a
            # whole-genome index, one upload + one HBM copy per device
            dev = self._devices[0]
            key = (id(self._index), dev)
            with _RESIDENT_LOCK:
                cached = _SEED_IX_CACHE.get(key)
                if cached is None:
                    # one index per run: drop other indexes' uploads
                    for k in [k for k in _SEED_IX_CACHE if k[0] != key[0]]:
                        del _SEED_IX_CACHE[k]
                    cached = _SEED_IX_CACHE[key] = (
                        self._index,  # strong ref keeps the id() valid
                        jax.device_put(self._index.hashes, dev),
                        jax.device_put(self._index.randstrobe_start_indices,
                                       dev),
                    )
            self._seed_ix = (cached[1], cached[2])
        codes, lens = self.engine.fx_codes(fx, n_records, self.SEED_L)
        # pad the batch rows to a power-of-two floor so chunk-size
        # variations reuse a handful of compiled programs (every distinct
        # N is a fresh XLA compile)
        n_pad = max(256, 1 << (n_records - 1).bit_length())
        if n_pad != n_records:
            codes = np.concatenate(
                [codes, np.full((n_pad - n_records, self.SEED_L), 4, np.uint8)]
            )
            lens = np.concatenate(
                [lens, np.zeros(n_pad - n_records, np.int32)]
            )
        sp = self._params.syncmer
        rp = self._params.randstrobe
        h, st, en, nf, nr, tie, pos = seed_and_find(
            codes,
            np.maximum(lens, 0).astype(np.int32),
            self._seed_ix[0], self._seed_ix[1],
            sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q,
            rp.max_dist, self.SEED_L, self._index.bits,
        )
        h = np.asarray(h)[:n_records]
        st = np.asarray(st)[:n_records]
        en = np.asarray(en)[:n_records]
        nf = np.asarray(nf)[:n_records]
        nr = np.asarray(nr)[:n_records]
        tie = np.asarray(tie)[:n_records]
        pos = np.asarray(pos)[:n_records]
        lens = lens[:n_records]
        M = self.SEED_L
        n_strobes = nf + nr
        counts = np.where(tie | (lens < 0), -1, n_strobes).astype(np.int32)
        # reads below the window size emit nothing on either path; keep
        # them on the device path with zero strobes
        valid = counts >= 0
        offsets = np.zeros(n_records + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(np.where(valid, n_strobes, 0))
        total = int(offsets[-1])
        fh = np.empty(total, dtype=np.uint64)
        fs = np.empty(total, dtype=np.int32)
        fe = np.empty(total, dtype=np.int32)
        fr = np.empty(total, dtype=np.uint8)
        fp = np.empty(total, dtype=np.int64)
        for i in np.flatnonzero(valid & (n_strobes > 0)):
            o = offsets[i]
            a, b = int(nf[i]), int(nr[i])
            fh[o : o + a] = h[i, :a]
            fs[o : o + a] = st[i, :a]
            fe[o : o + a] = en[i, :a]
            fr[o : o + a] = 0
            fp[o : o + a] = pos[i, :a]
            fh[o + a : o + a + b] = h[i, M : M + b]
            fs[o + a : o + a + b] = st[i, M : M + b]
            fe[o + a : o + a + b] = en[i, M : M + b]
            fr[o + a : o + a + b] = 1
            fp[o + a : o + a + b] = pos[i, M : M + b]
        return self.engine.chunk_a_fx_pre(
            fx, chunk_index, counts, offsets[:-1].copy(), fh, fs, fe, fr, fp
        )

    def _shard_chunk_a(self, fx, n_records, chunk_index):
        """Phase A with every index lookup served by the sharded index:
        host seeding (no index access) -> one batched find_runs over the
        mesh -> host preflight of the rescue take-rule (it depends only
        on per-strobe counts, which the first lookup returned) -> a
        second capped lookup for exactly the strobes rescue will walk ->
        engine RunFeed. Counters: engine feed_miss must stay 0."""
        import numpy as np

        eng = self.engine
        si = self._sharded
        # host-routed lookups (no device collectives; element-equal to the
        # psum variant — tests/test_sharded_index.py)
        find = getattr(si, "find_runs_routed", si.find_runs)
        h, total = eng.fx_seed_only(fx)
        counts, offsets, hashes, starts, ends, rev = eng.fx_seed_copy(
            h, n_records, total)
        fc = int(si.filter_cutoff)
        if total:
            res = find(hashes, fc)
            cnt = res["count"]
            filt = res["filtered"]
        else:
            cnt = np.zeros(0, np.int64)
            filt = np.zeros(0, bool)
        walk = (cnt > 0) & ~filt
        rows = np.flatnonzero(walk)
        widths = cnt[rows]
        run_off = np.full(max(total, 1), -1, np.int64)
        if rows.size:
            run_off[rows] = np.concatenate(
                ([0], np.cumsum(widths)[:-1]))
            colmask = np.arange(fc)[None, :] < widths[:, None]
            run_pos = np.ascontiguousarray(
                res["run_positions"][rows][colmask], dtype=np.uint32)
            run_packed = np.ascontiguousarray(
                res["run_packed"][rows][colmask], dtype=np.uint32)
        else:
            run_pos = np.zeros(1, np.uint32)
            run_packed = np.zeros(1, np.uint32)

        # rescue preflight: the engine rescues when nams are empty or the
        # float32 nonrepetitive fraction compares < 0.7f — and with run
        # feeds, nams are empty iff no unfiltered hit exists
        resc_off = np.full(max(total, 1), -1, np.int64)
        resc_pos = np.zeros(1, np.uint32)
        resc_packed = np.zeros(1, np.uint32)
        if total and self._map_param.rescue_level > 1:
            read_id = np.repeat(np.arange(n_records),
                                np.diff(offsets).astype(np.int64))
            found = cnt > 0
            tot_r = np.bincount(read_id[found], minlength=n_records)
            good_r = np.bincount(read_id[walk], minlength=n_records)
            frac = np.ones(n_records, np.float32)
            nz = tot_r > 0
            frac[nz] = (good_r[nz].astype(np.float32)
                        / tot_r[nz].astype(np.float32))
            rescue = (good_r == 0) | (frac < np.float32(0.7))
            cutoff = int(self._map_param.rescue_cutoff)
            sel_parts = []
            for r in np.flatnonzero(rescue):
                lo, hi = int(offsets[r]), int(offsets[r + 1])
                gi0 = np.arange(lo, hi)
                gi0 = gi0[cnt[lo:hi] > 0]
                if gi0.size == 0:
                    continue
                for orient in (0, 1):
                    g = gi0[rev[gi0] == orient]
                    if g.size == 0:
                        continue
                    order = np.lexsort((ends[g], starts[g], cnt[g]))
                    g = g[order]
                    c = cnt[g]
                    n0 = int((c <= cutoff).sum())
                    if n0 >= 5:
                        # the engine's walk hard-stops at count > 1000
                        # regardless of the cutoff (reference nam.cpp
                        # take-rule `|| rh.count > 1000`), so strobes
                        # past that are never consumed — and prefetching
                        # them would overflow the cap_r=1024 run packing
                        # when -R pushes cutoff past 1024
                        take = g[: int((c <= min(cutoff, 1000)).sum())]
                    else:
                        ok = g[c <= 1000]
                        k = min(len(ok), 5)
                        if 0 < k < len(ok):
                            # the take-rule's 5-hit budget can land inside
                            # a (count, qs, qe) tie class whose member
                            # order is the unstable introsort's choice —
                            # feed the whole class so any member works
                            bq = (cnt[ok[k - 1]], starts[ok[k - 1]],
                                  ends[ok[k - 1]])
                            while (k < len(ok)
                                   and (cnt[ok[k]], starts[ok[k]],
                                        ends[ok[k]]) == bq):
                                k += 1
                        take = ok[:k]
                    if take.size:
                        sel_parts.append(take)
            if sel_parts:
                sel = np.concatenate(sel_parts)
                # one strobe can be selected for several reads? no — gi
                # ranges are disjoint per read, so sel is unique
                cap_r = 1
                cmax = int(cnt[sel].max())
                while cap_r < cmax:
                    cap_r *= 2
                cap_r = min(cap_r, 1024)
                w = cnt[sel]
                resc_off[sel] = np.concatenate(([0], np.cumsum(w)[:-1]))
                pos_parts, packed_parts = [], []
                step = max(1, 2_000_000 // cap_r)
                for s0 in range(0, sel.size, step):
                    part = sel[s0 : s0 + step]
                    r2 = find(hashes[part], cap_r)
                    m2 = (np.arange(cap_r)[None, :]
                          < cnt[part][:, None])
                    pos_parts.append(r2["run_positions"][m2])
                    packed_parts.append(r2["run_packed"][m2])
                resc_pos = np.ascontiguousarray(
                    np.concatenate(pos_parts), dtype=np.uint32)
                resc_packed = np.ascontiguousarray(
                    np.concatenate(packed_parts), dtype=np.uint32)

        return eng.chunk_a_fx_runs(
            fx, chunk_index, counts, offsets, hashes, starts, ends, rev,
            np.ascontiguousarray(cnt, dtype=np.int64) if total else np.zeros(1, np.int64),
            np.ascontiguousarray(filt, dtype=np.uint8) if total else np.zeros(1, np.uint8),
            run_off, run_pos, run_packed, resc_off, resc_pos, resc_packed,
        )

    def _dispatch(self, buf, Q, T, sub):
        """Launch one extend dispatch on the next device (round-robin),
        gathering targets from that device's resident reference copy."""
        import jax

        from ..ops.extend_device import extend_batch_packed_resident_q2

        di = 0
        if len(self._devices) > 1:
            di = next(self._device_rr) % len(self._devices)
            self._next_dev += 1
            buf = jax.device_put(buf, self._devices[di])
        return extend_batch_packed_resident_q2(
            buf, self._ref_codes[di], Q, T, self._sw, sub, self.kernel)

    def _extend_chunk(self, chunk):
        """Dispatch a phase-A chunk's gapped jobs to the device in bucket
        batches (asynchronously); returns the pending (idxs, result, D)
        list finish_chunk consumes."""
        pending = []
        if not (self.use_device and chunk.n_jobs):
            return pending
        for idxs, Q, T, B, sub in self.engine.plan_batches(chunk, self.batch_size):
            buf = self._fill(chunk, idxs, B, Q, T)
            pending.append((idxs, self._dispatch(buf, Q, T, sub), Q + T - 1))
            self.device_pairs += len(idxs)
        for _, out_dev, _ in pending:
            # start the device->host copy as soon as the batch lands so
            # finish_chunk's np.asarray is a wait, not a transfer
            out_dev.copy_to_host_async()
        return pending

    # --- two-phase API (callers drive the cross-chunk pipelining) -------

    def start_chunk(self, records1, records2, records3, chunk_index: int):
        """Phase A + async device dispatch; returns an opaque state."""
        chunk = self.engine.chunk_a(records1, records2, records3, chunk_index)
        return chunk, self._extend_chunk(chunk)

    def finish_chunk(self, state) -> bytes:
        """Collect device results + phase B; returns the output bytes
        (SAM/PAF text is ASCII; writers are binary)."""
        chunk, pending = state
        for idxs, out_dev, D in pending:
            self.engine.set_device_results(chunk, np.asarray(out_dev), D, idxs)
        return self.engine.chunk_b_bytes(chunk)

    def map_all(
        self,
        chunks: Iterable[Tuple[int, list, list, list]],
        write: Callable[[str], None],
        depth: int = 3,
    ) -> int:
        """Software-pipelined mapping over (index, r1, r2, r3) chunks with
        up to `depth` chunks in flight (device transfers of older chunks
        overlap host seeding of newer ones); returns reads mapped.

        Note: phase B of chunk i runs after phase A of chunks i+1..i+depth,
        so the insert-size estimator trails by `depth` chunks — the same
        staleness the reference's overlapped workers have
        (/root/reference/src/pc.cpp cross-chunk rotation)."""
        from collections import deque

        boost_mapping_thread()
        n_reads = 0
        in_flight = deque()
        for chunk_index, r1, r2, r3 in chunks:
            n_reads += len(r1) + len(r2) + len(r3)
            in_flight.append(self.start_chunk(r1, r2, r3, chunk_index))
            if len(in_flight) > depth:
                write(self.finish_chunk(in_flight.popleft()))
        while in_flight:
            write(self.finish_chunk(in_flight.popleft()))
        return n_reads

    def counters(self) -> dict:
        return {**self.engine.counters(), "device_pairs": self.device_pairs}


def native_pipeline_available() -> bool:
    return engine_available()


class _Prewarm(threading.Thread):
    """Non-daemon worker whose exception is kept and re-raised by
    result(): a compile failure must stop the run, not vanish."""

    def __init__(self, fn):
        super().__init__(daemon=False)
        self._fn = fn
        self.error = None

    def run(self):
        try:
            self._fn()
        except Exception as e:  # re-raised by result() in the caller
            self.error = e

    def result(self) -> None:
        self.join()
        if self.error is not None:
            raise self.error


def prewarm_extend_programs(aln_params, batch_size: int = 1024,
                            r: int = 150, ref_len: int = 1) -> _Prewarm:
    """Compile (or cache-load) the extend program of this platform for
    every bucket shape the planner can emit, in a thread, so the work
    (including the CUDA library's first build) overlaps reference loading
    and index building. Call result() on the returned thread before
    mapping: it waits and re-raises any failure."""

    def run():
        import jax

        from ..native.engine import engine_buckets
        from ..ops.extend_device import (
            REF_PAGE_OVERLAP,
            REF_PAGE_SIZE,
            _extend_resident_q2,
            extend_program,
        )
        from ..ops.sw_jax import SwParams

        body = extend_program(jax.devices()[0].platform)
        sw = SwParams(aln_params.match, aln_params.mismatch,
                      aln_params.gap_open, aln_params.gap_extend)
        # the resident pages' shape depends only on the genome length
        n_pages = max(1, -(-ref_len // REF_PAGE_SIZE))
        width = min(REF_PAGE_SIZE, max(ref_len, 1)) + REF_PAGE_OVERLAP
        codes_s = jax.ShapeDtypeStruct((n_pages, width), np.uint8)
        for Q, T, bcap, groups in engine_buckets(r):
            sub = min(batch_size, bcap)
            rows = (Q + 3) // 4 + (Q + 7) // 8 + 8
            # every power-of-two group count the planner can emit
            g = 1
            while True:
                buf_s = jax.ShapeDtypeStruct((rows, sub * g), np.uint8)
                with jax.enable_x64(False):
                    _extend_resident_q2.lower(
                        buf_s, codes_s, Q, T, sw, sub, body).compile()
                if g >= groups:
                    break
                g *= 2

    t = _Prewarm(run)
    t.start()
    return t


def _pipeline_map_file(self, path1, path2, interleaved, chunk_size, write,
                       depth: int = 3, progress=None) -> int:
    """Fully-native input path: the C++ reader parses chunks, phase A
    consumes them zero-copy, the device extends, phase B writes output.
    Returns the number of reads mapped. `progress(n_reads)` is called
    after every chunk when given (the reference's reads/s reporter,
    /root/reference/src/main.cpp:146-181)."""
    from collections import deque

    from ..native.engine import NativeReader

    boost_mapping_thread()
    reader = NativeReader(path1, path2, interleaved, chunk_size)
    n_reads = 0
    in_flight = deque()
    try:
        for chunk_index, fx, n_pairs, n_singles in reader:
            n_reads += 2 * n_pairs + n_singles
            if progress is not None:
                progress(n_reads)
            try:
                if self.shard_index:
                    chunk = self._shard_chunk_a(fx, 2 * n_pairs + n_singles,
                                                chunk_index)
                elif self.device_seed:
                    chunk = self._preseed(fx, 2 * n_pairs + n_singles,
                                          chunk_index)
                else:
                    chunk = self.engine.chunk_a_fx(fx, chunk_index)
            finally:
                reader.free_chunk(fx)  # pooled buffer must always return
            in_flight.append((chunk, self._extend_chunk(chunk)))
            if len(in_flight) > depth:
                write(self.finish_chunk(in_flight.popleft()))
        while in_flight:
            write(self.finish_chunk(in_flight.popleft()))
    finally:
        reader.close()
    return n_reads


NativePipeline.map_file = _pipeline_map_file


class ThreadedNativePipeline:
    """N-worker chunk mapping — the reference's consumer-thread data
    parallelism (/root/reference/src/main.cpp:453-592 worker spawn,
    src/pc.cpp InputBuffer/OutputBuffer): a reader/producer feeds a
    bounded queue, each worker owns a NativeEngine (per-worker insert-size
    estimator and statistics, like the reference's per-thread state) and
    processes whole chunks; output is reordered by chunk index before
    writing. Engine calls release the GIL, so workers scale on multicore
    hosts; device dispatch happens on the worker threads (jax dispatch is
    thread-safe).

    Like the reference, PE output depends on which worker handled which
    chunk (insert-size history); SE output is identical for any worker
    count. With ``deterministic=True`` chunks are handed out round-robin
    (worker w gets chunk indices w, w+N, w+2N, ...) instead of
    first-free-worker, which makes PE output a pure function of
    (input, n_workers) — repeat runs are byte-identical, at the cost of
    head-of-line blocking when chunk costs are skewed. The reference has
    no such mode (its assignment is scheduler-dependent,
    /root/reference/src/pc.cpp InputBuffer); it exists here so the
    N-worker PE path is regression-testable.
    """

    def __init__(
        self,
        index,
        index_parameters,
        references,
        aln_params,
        map_param,
        read_group_id: str = "",
        use_device: bool = True,
        batch_size: int = 1024,
        n_workers: int = 3,
        queue_depth: int = 8,
        kernel=None,
        deterministic: bool = False,
        device_seed: bool = False,
        shard_index: bool = False,
        pin_workers: bool = False,
    ):
        sharded = None
        if shard_index:
            # one sharded index serves all workers (its device arrays and
            # compiled lookup programs are shared; find_runs is thread-safe)
            from ..parallel.sharding import ShardedIndex, make_mesh

            sharded = ShardedIndex(make_mesh(), index)
        device_rr = itertools.count()
        self._mk = lambda: NativePipeline(
            index, index_parameters, references, aln_params, map_param,
            read_group_id, use_device=use_device, batch_size=batch_size,
            kernel=kernel, device_seed=device_seed,
            shard_index=shard_index, sharded_index=sharded,
            device_rr=device_rr,
        )
        self.n_workers = max(1, n_workers)
        self.queue_depth = queue_depth
        self.deterministic = deterministic
        self.pin_workers = pin_workers
        self.pinned_cpus = []  # (wid, cpu) telemetry, filled by workers
        self._counters = []
        self._timers = []

    def map_file(self, path1, path2, interleaved, chunk_size, write,
                 progress=None) -> int:
        import queue
        import threading

        from ..native.engine import NativeReader

        # per-run telemetry: a reused pipeline object must not report
        # the previous map_file call's counters twice
        self._counters = []
        self._timers = []

        # deterministic mode: one queue per worker, chunks routed by
        # index % n_workers; default: one shared queue, first free worker
        if self.deterministic:
            in_qs = [queue.Queue(maxsize=max(2, self.queue_depth // self.n_workers))
                     for _ in range(self.n_workers)]
        else:
            in_qs = [queue.Queue(maxsize=self.queue_depth)]
        out_lock = threading.Condition()
        out_buf = {}
        next_out = [0]
        n_reads = [0]
        errors = []

        def emit(ci, text):
            with out_lock:
                out_buf[ci] = text
                while next_out[0] in out_buf:
                    write(out_buf.pop(next_out[0]))
                    next_out[0] += 1
                out_lock.notify_all()

        def worker(wid):
            if self.pin_workers:
                cpu = pin_worker_thread(wid)
                if cpu is not None:
                    self.pinned_cpus.append((wid, cpu))
            boost_mapping_thread()
            in_q = in_qs[wid % len(in_qs)]
            pipe = None
            prev = None  # (ci, state): per-worker double buffering — the
            # device extends this worker's chunk i while it seeds i+1
            # (the reference's per-worker E1/SEED/E2 rotation)
            try:
                # inside the try: a construction failure (device OOM,
                # backend init) must reach `errors`, or the producer's
                # bounded put would retry forever against a dead worker
                pipe = self._mk()
                while True:
                    item = in_q.get()
                    if item is None:
                        break
                    ci, fx, np_, ns = item
                    try:
                        if pipe.shard_index:
                            chunk = pipe._shard_chunk_a(fx, 2 * np_ + ns, ci)
                        elif pipe.device_seed:
                            chunk = pipe._preseed(fx, 2 * np_ + ns, ci)
                        else:
                            chunk = pipe.engine.chunk_a_fx(fx, ci)
                    finally:
                        reader.free_chunk(fx)
                    pending = pipe._extend_chunk(chunk)
                    if prev is not None:
                        emit(prev[0], pipe.finish_chunk(prev[1]))
                    prev = (ci, (chunk, pending))
                if prev is not None:
                    emit(prev[0], pipe.finish_chunk(prev[1]))
                    prev = None
            except Exception as e:  # pragma: no cover - propagate to caller
                errors.append(e)
                with out_lock:
                    out_lock.notify_all()
            finally:
                if pipe is not None:
                    self._counters.append(pipe.counters())
                    self._timers.append(pipe.engine.timers())

        reader = NativeReader(path1, path2, interleaved, chunk_size)
        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.n_workers)
        ]
        for t in threads:
            t.start()
        try:
            for ci, fx, np_, ns in reader:
                n_reads[0] += 2 * np_ + ns
                if progress is not None:
                    progress(n_reads[0])
                q_i = ci % len(in_qs)
                # bounded put that cannot deadlock if all workers died
                while True:
                    if errors:
                        reader.free_chunk(fx)
                        break
                    try:
                        in_qs[q_i].put((ci, fx, np_, ns), timeout=1.0)
                        break
                    except queue.Full:
                        continue
                if errors:
                    break
        finally:
            if self.deterministic:
                # one private queue per worker: the sentinel can only be
                # consumed by its owner, so a per-worker alive check is safe
                for w in range(self.n_workers):
                    q_i = w % len(in_qs)
                    while threads[w].is_alive():
                        try:
                            in_qs[q_i].put(None, timeout=1.0)
                            break
                        except queue.Full:
                            if not threads[w].is_alive():
                                break
            else:
                # shared queue: ANY worker can consume ANY sentinel, so a
                # per-worker alive check races (a worker that eats a
                # sentinel posted "for" another index and exits leaves a
                # still-alive worker blocked in get() forever and its
                # buffered chunk unflushed). Snapshot the alive set once
                # and post exactly that many sentinels unconditionally.
                n_alive = sum(t.is_alive() for t in threads)
                posted = 0
                while posted < n_alive:
                    try:
                        in_qs[0].put(None, timeout=1.0)
                        posted += 1
                    except queue.Full:
                        if not any(t.is_alive() for t in threads):
                            break
            for t in threads:
                if errors:
                    # a failed run salvages what it can but must not hang
                    t.join(timeout=60.0)
                else:
                    # healthy workers ALWAYS exit once their sentinel
                    # arrives — wait for them unconditionally. A bounded
                    # join here silently dropped the last chunk of any
                    # worker still inside a long device wait (e.g. a lazy
                    # 20-40 s extend-program compile on the first run) and
                    # then aborted the process at exit when the daemon
                    # thread was torn down inside a jax call.
                    t.join()
            reader.close()
        if errors:
            raise errors[0]
        # flush any leftover ordered output (all chunks are in out_buf now)
        for ci in sorted(out_buf):
            write(out_buf.pop(ci))
        return n_reads[0]

    def counters(self) -> dict:
        total: dict = {}
        for c in self._counters:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        return total

    def timers(self) -> dict:
        total: dict = {}
        for t in self._timers:
            for k, v in t.items():
                total[k] = total.get(k, 0.0) + v
        return total


def _pipeline_map_file_sharded(self, path1, path2, interleaved, chunk_size,
                               shard_writer, process_index: int,
                               process_count: int, depth: int = 3) -> int:
    """Multi-host shard of map_file: every host parses the stream (cheap
    next to mapping) but seeds/aligns only chunks with
    index % process_count == process_index, writing (chunk_index, text)
    pairs to its ShardWriter for the global-order merge."""
    from collections import deque

    from ..native.engine import NativeReader

    boost_mapping_thread()
    reader = NativeReader(path1, path2, interleaved, chunk_size)
    n_reads = 0
    in_flight = deque()
    try:
        for chunk_index, fx, n_pairs, n_singles in reader:
            if chunk_index % process_count != process_index:
                reader.free_chunk(fx)
                continue
            n_reads += 2 * n_pairs + n_singles
            if self.shard_index:
                chunk = self._shard_chunk_a(fx, 2 * n_pairs + n_singles,
                                            chunk_index)
            elif self.device_seed:
                chunk = self._preseed(fx, 2 * n_pairs + n_singles, chunk_index)
            else:
                chunk = self.engine.chunk_a_fx(fx, chunk_index)
            reader.free_chunk(fx)
            in_flight.append((chunk_index, (chunk, self._extend_chunk(chunk))))
            if len(in_flight) > depth:
                ci, state = in_flight.popleft()
                shard_writer.write_chunk(ci, self.finish_chunk(state))
        while in_flight:
            ci, state = in_flight.popleft()
            shard_writer.write_chunk(ci, self.finish_chunk(state))
    finally:
        reader.close()
    return n_reads


NativePipeline.map_file_sharded = _pipeline_map_file_sharded
