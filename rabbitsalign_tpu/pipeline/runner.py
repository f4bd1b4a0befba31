"""Application driver: index build/load, chunked mapping loop, output.

Plays the role of reference src/main.cpp run_rabbitsalign + the worker
loops in src/pc.cpp. Chunks are processed in order; the per-chunk RNG is
seeded with the chunk index for reproducibility (reference
src/pc.cpp:583,706). The NUMA index-replication machinery of the
reference has no analog here (the index is one set of numpy/device arrays
shared by the process); multi-device scaling is handled by the parallel/
package instead.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, TextIO

import numpy as np

from ..align.aligner import Aligner, AlignmentParameters
from ..cli import CommandLineOptions
from ..index.params import DEFAULT, IndexParameters
from ..index.strobemer_index import StrobemerIndex
from ..io.fasta import References
from ..io.fastq import InputBuffer, estimate_read_length
from ..io.sam import CIGAR_OPS_EQX, CIGAR_OPS_M, Sam, sam_header
from ..map.common import InsertSizeDistribution, MappingParameters
from ..map.randomness import MinstdRand
from ..map.stats import AlignmentStatistics
from ..utils.logger import logger


def run_aligner(opt: CommandLineOptions) -> int:
    logger.set_level("debug" if opt.verbose else "info")
    t_start = time.perf_counter()

    if opt.c >= 64 or opt.c <= 0:
        raise ValueError("c must be greater than 0 and less than 64")

    if not opt.r_set and opt.reads_filename1:
        opt.r = estimate_read_length(opt.reads_filename1, opt.reads_filename2,
                                     opt.is_interleaved)
        logger.info(f"Estimated read length: {opt.r} bp")

    index_parameters = IndexParameters.from_read_length(
        opt.r,
        opt.k if opt.k_set else DEFAULT,
        opt.s if opt.s_set else DEFAULT,
        opt.l if opt.l_set else DEFAULT,
        opt.u if opt.u_set else DEFAULT,
        opt.c if opt.c_set else DEFAULT,
        opt.max_seed_len if opt.max_seed_len_set else DEFAULT,
    )
    aln_params = AlignmentParameters(
        match=opt.A, mismatch=opt.B, gap_open=opt.O, gap_extend=opt.E,
        end_bonus=opt.end_bonus,
    )
    map_param = MappingParameters(
        r=opt.r,
        max_secondary=opt.max_secondary,
        dropoff_threshold=opt.dropoff_threshold,
        rescue_level=opt.rescue_level,
        max_tries=opt.max_tries,
        is_sam_out=opt.is_sam_out,
        cigar_eqx=opt.cigar_eqx,
        output_unmapped=opt.output_unmapped,
        details=opt.details,
        pe_ref_async=getattr(opt, "pe_ref_async", False),
    )
    map_param.verify()

    t0 = time.perf_counter()
    references = References.from_fasta(opt.ref_filename)
    logger.info(f"Time reading reference: {time.perf_counter() - t0:.2f} s")
    if references.total_length() == 0:
        raise RuntimeError("No reference sequences found")
    logger.info(
        f"Reference size: {references.total_length() / 1e6:.2f} Mbp "
        f"({len(references)} contig{'s' if len(references) != 1 else ''})"
    )

    prewarm = None
    if (getattr(opt, "use_tpu", False) and not opt.only_gen_index
            and aln_params.gap_extend < aln_params.gap_open):
        # compile/cache-load the extend programs (their shapes depend on
        # the genome LENGTH only) while the host builds or reads the
        # index. An -i run never maps, so it must not pay these compiles.
        # gap_extend >= gap_open mirrors NativePipeline's O==E gate:
        # device extension is disabled there.
        from .native_pipeline import prewarm_extend_programs

        prewarm = prewarm_extend_programs(
            aln_params, getattr(opt, "tpu_batch", 1024), r=opt.r,
            ref_len=references.total_length())

    index = StrobemerIndex(references, index_parameters, opt.bits)
    mmap_ok = False  # did a sidecar open (with its own warmer) succeed?
    if opt.use_index:
        sti_path = opt.ref_filename + index_parameters.filename_extension()
        logger.info(f"Reading index from {sti_path}")
        t0 = time.perf_counter()
        # --mmap-index: O(1) open via the columnar sidecar (built on
        # first use); pages fault in on demand while a warmer thread
        # streams the files through the page cache, so mapping overlaps
        # the disk instead of stalling minutes behind a 12 GB fread-
        # style load at GRCh38 scale
        if getattr(opt, "mmap_index", False):
            mmap_ok = index.read_mmap(sti_path)
            if not mmap_ok:
                index.read(sti_path)
                logger.info("Building mmap sidecar (one-time) ...")
                index.write_columns(sti_path)
            else:
                logger.info("Index mapped from columnar sidecar")
        else:
            index.read(sti_path)
        logger.info(f"Total time reading index: {time.perf_counter() - t0:.2f} s")
    else:
        logger.info("Indexing ...")
        t0 = time.perf_counter()
        index.populate(opt.f, opt.n_threads)
        logger.info(f"Total time indexing: {time.perf_counter() - t0:.2f} s")
        st = index.stats
        logger.debug(f"Total number of randstrobes: {st.tot_strobemer_count}")
        logger.debug(f"Total number of distinct randstrobes: {st.distinct_strobemers}")
        if st.distinct_strobemers:
            frac1 = st.tot_occur_once / st.distinct_strobemers
            logger.debug(f"Fraction of unique randstrobes: {frac1:.4f}")
            logger.debug(f"Highly abundant randstrobes (>100): {st.tot_high_ab}")
            logger.debug(f"Mid abundance randstrobes (2-100): {st.tot_mid_ab}")
        logger.debug(f"Filter cutoff: {index.filter_cutoff}")
        if opt.logfile_name:
            from ..index.diagnostics import print_diagnostics

            print_diagnostics(index, opt.logfile_name, index_parameters.syncmer.k)
        if opt.only_gen_index:
            sti_path = opt.ref_filename + index_parameters.filename_extension()
            logger.info(f"Writing index to {sti_path}")
            index.write(sti_path)
            # write the mmap sidecar at creation time: the first
            # --mmap-index run at GRCh38 scale must open in <1 s, not
            # silently pay a full .sti read + ~12 GB rewrite (the lazy
            # build in map-mode stays as the fallback). The sidecar is
            # a second full copy of the arrays: --no-sidecar skips it,
            # and a failed write (e.g. ENOSPC) must not fail the -i run
            # — the .sti above is the real artifact
            if not getattr(opt, "no_sidecar", False):
                logger.info("Writing mmap sidecar (columnar)")
                try:
                    index.write_columns(sti_path)
                except OSError as e:
                    logger.warning(
                        f"sidecar write failed ({e}); the .sti is intact "
                        f"— the sidecar will be built lazily on first "
                        f"--mmap-index use")
            return 0

    # Big freshly-loaded index arrays (plain .sti read or fresh build)
    # carry a first-pass page-mapping penalty (see
    # strobemer_index.warm_index_random_access);
    # burn it off in the background while mapping starts. The mmap
    # path's warmer thread does this itself after streaming — but only
    # when the sidecar open SUCCEEDED (a first --mmap-index run falls
    # back to a plain read + sidecar build and is exactly as cold as
    # the non-mmap path)
    if (not mmap_ok
            and getattr(index.hashes, "nbytes", 0) > (1 << 30)):
        import threading

        from ..index.strobemer_index import warm_index_random_access

        threading.Thread(
            target=warm_index_random_access,
            args=(index.hashes, index.positions,
                  index.randstrobe_start_indices),
            daemon=True).start()

    map_param.rescue_cutoff = (
        map_param.rescue_level * index.filter_cutoff
        if map_param.rescue_level < 100
        else 1000
    )
    logger.debug(f"Using rescue cutoff: {map_param.rescue_cutoff}")

    # binary output end-to-end: the engine produces ASCII SAM/PAF bytes
    out = (
        sys.stdout.buffer if opt.write_to_stdout
        else open(opt.output_file_name, "wb")
    )
    import contextlib

    profiler_cm = contextlib.nullcontext()
    if getattr(opt, "profile_dir", None):
        # tracing subsystem: one jax.profiler trace of the whole mapping
        # run (host + device), viewable in TensorBoard/Perfetto — the
        # analog of the reference's Timer/rdtsc micro-timers
        # (src/aln.hpp:13-56, src/pc.cpp:543-551)
        import jax

        profiler_cm = jax.profiler.trace(opt.profile_dir)
    if prewarm is not None:
        t0 = time.perf_counter()
        prewarm.result()  # a failed compile stops the run here
        logger.info(f"Extend programs ready after a further "
                    f"{time.perf_counter() - t0:.2f} s")
    try:
        with profiler_cm:
            _map_reads(opt, out, references, index, index_parameters,
                       map_param, aln_params)
        out.flush()
    finally:
        if not opt.write_to_stdout:
            out.close()
    logger.info("Done!")
    logger.info(f"Total time mapping: {time.perf_counter() - t_start:.2f} s.")
    return 0


def _make_progress(opt, t_start):
    """Periodic reads/s line on stderr (reference src/main.cpp:146-181);
    active when --no-progress is not given and stderr is a terminal."""
    if not opt.show_progress or not sys.stderr.isatty():
        return None
    state = {"last": 0.0}

    def progress(n_reads: int) -> None:
        now = time.perf_counter()
        if now - state["last"] >= 1.0:
            state["last"] = now
            rate = n_reads / max(now - t_start, 1e-9)
            print(f" Processed {n_reads} reads in {now - t_start:.1f} s "
                  f"({rate:.0f} reads/s)", end="\r", file=sys.stderr)

    return progress


def _log_extend_device() -> None:
    """Say which device and extend program the run extends on."""
    import jax

    from ..ops.extend_device import extend_program

    dev = jax.devices()[0]
    logger.info(
        f"Extending on {dev.platform} ({dev.device_kind}, "
        f"{len(jax.local_devices())} device(s)) with the "
        f"{extend_program(dev.platform).label}")


def _map_reads(
    opt: CommandLineOptions,
    out: TextIO,
    references: References,
    index: StrobemerIndex,
    index_parameters: IndexParameters,
    map_param: MappingParameters,
    aln_params: AlignmentParameters,
) -> None:
    use_tpu = getattr(opt, "use_tpu", False)

    # Production path: the native (C++) engine runs phases A and B with
    # the device extension batches in between; the pure-Python path below
    # is the validated golden implementation.
    from .native_pipeline import NativePipeline, native_pipeline_available

    multihost = getattr(opt, "num_nodes", 1) > 1
    if multihost and not native_pipeline_available():
        # N pod hosts silently falling back to the single-node path would
        # all map the full input into the SAME output file concurrently
        raise RuntimeError(
            "--num-nodes > 1 requires the native engine; it failed to "
            "build/load on this host")
    if map_param.is_sam_out and not multihost:
        cmd_line = " ".join(sys.argv)
        out.write(
            sam_header(references, opt.read_group_id, opt.read_group_fields,
                       cmd_line).encode()
        )

    input_buffer = InputBuffer(
        opt.reads_filename1, opt.reads_filename2, opt.chunk_size, opt.is_interleaved
    )

    if multihost:
        # multi-host pod run: chunk-sharded mapping, per-host output
        # shards merged into chunk order by node 0 (SURVEY.md §2.7 — new
        # scale-out design; the reference is single-node)
        from ..parallel.multihost import (
            ShardWriter,
            init_distributed,
            merge_output,
            psum_statistics,
        )

        if not use_tpu:
            # a host-only pod member needs no accelerator: keep every
            # process off the card (must run before any backend starts)
            import jax

            jax.config.update("jax_platforms", "cpu")
        pid, pcount = init_distributed(
            getattr(opt, "coordinator", None), opt.num_nodes,
            getattr(opt, "node_id", 0),
        )
        if use_tpu:
            _log_extend_device()
        # --pod-index-peers: the index GENUINELY split across pod hosts
        # (each keeps only its hash-range slice; remote-owned keys go to
        # the owning host over the TCP side channel). Pair with
        # --mmap-index and a host never materializes the full index in
        # RAM: the slice is copied out of the memmap and the mapped
        # pages drop back to the page cache.
        sharded = None
        shard_flag = getattr(opt, "shard_index", False)
        pod_peers = getattr(opt, "pod_index_peers", "") or ""
        if pod_peers:
            from ..parallel.multihost import PodShardedIndex

            peers = pod_peers.split(",")
            if len(peers) != pcount:
                raise RuntimeError(
                    f"--pod-index-peers lists {len(peers)} endpoints for a "
                    f"{pcount}-host pod")
            sharded = PodShardedIndex(index, pid, pcount, peers)
            index.hashes = np.zeros(0, dtype=np.uint64)
            index.positions = np.zeros(0, dtype=np.uint32)
            index.packed = np.zeros(0, dtype=np.uint32)
            shard_flag = True
            logger.info(
                f"Pod-sharded index: host {pid} holds "
                f"{sharded._h.shape[0]} of the randstrobes "
                f"({sharded._h.nbytes / 1e9:.2f} GB slice)")
        pipeline = NativePipeline(
            index, index_parameters, references, aln_params, map_param,
            opt.read_group_id, use_device=use_tpu,
            batch_size=getattr(opt, "tpu_batch", 1024),
            device_seed=getattr(opt, "device_seed", False),
            shard_index=shard_flag, sharded_index=sharded,
        )
        if opt.n_threads > 1 or getattr(opt, "deterministic", False):
            logger.info("multi-host mode runs one mapping thread per host; "
                        "-t/--deterministic apply to single-host runs")
        writer = ShardWriter(opt.output_file_name, pid, pcount)
        t0 = time.perf_counter()
        n_reads = pipeline.map_file_sharded(
            opt.reads_filename1, opt.reads_filename2, opt.is_interleaved,
            opt.chunk_size, writer, pid, pcount,
        )
        writer.close()
        stats_sum = psum_statistics({"n_reads": n_reads, **pipeline.counters()})
        if pcount > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices("rabbitsalign-merge")
            if pid == 0:
                header = ""
                if map_param.is_sam_out:
                    header = sam_header(
                        references, opt.read_group_id, opt.read_group_fields,
                        " ".join(sys.argv),
                    )
                merge_output(opt.output_file_name, pcount, header)
        elapsed = time.perf_counter() - t0
        logger.info(f"Host {pid}/{pcount}: mapped {n_reads} reads in "
                    f"{elapsed:.2f} s; pod total {stats_sum['n_reads']:.0f}")
        return

    if use_tpu:
        _log_extend_device()
    if native_pipeline_available():
        if opt.n_threads > 1:
            from .native_pipeline import ThreadedNativePipeline

            pipeline = ThreadedNativePipeline(
                index, index_parameters, references, aln_params, map_param,
                opt.read_group_id, use_device=use_tpu,
                batch_size=getattr(opt, "tpu_batch", 1024),
                n_workers=opt.n_threads,
                deterministic=getattr(opt, "deterministic", False),
                device_seed=getattr(opt, "device_seed", False),
                shard_index=getattr(opt, "shard_index", False),
                pin_workers=getattr(opt, "pin_workers", False),
            )
            t0 = time.perf_counter()
            n_reads = pipeline.map_file(
                opt.reads_filename1, opt.reads_filename2, opt.is_interleaved,
                opt.chunk_size, out.write, progress=_make_progress(opt, t0),
            )
            elapsed = time.perf_counter() - t0
        else:
            pipeline = NativePipeline(
                index, index_parameters, references, aln_params, map_param,
                opt.read_group_id, use_device=use_tpu,
                batch_size=getattr(opt, "tpu_batch", 1024),
                device_seed=getattr(opt, "device_seed", False),
                shard_index=getattr(opt, "shard_index", False),
            )
            t0 = time.perf_counter()
            progress = _make_progress(opt, t0)
            # fully-native input path (C++ chunked FASTQ reader). No
            # retry-from-scratch fallback here: map_file writes output
            # incrementally, so re-running after a mid-run failure would
            # append duplicate records — let the error propagate.
            n_reads = pipeline.map_file(
                opt.reads_filename1, opt.reads_filename2, opt.is_interleaved,
                opt.chunk_size, out.write, progress=progress,
            )
            elapsed = time.perf_counter() - t0
        c = pipeline.counters()
        logger.info(f"Mapped {n_reads} reads in {elapsed:.2f} s "
                    f"({n_reads / max(elapsed, 1e-9):.0f} reads/s)")
        logger.info(f"Total mapping sites tried: {c['tot_all_tried']}")
        logger.info(f"Total calls to ssw: {c['aligner_calls']}")
        logger.info(f"Device-extended pairs: {c['device_pairs']}")
        logger.info(f"Inconsistent NAM ends: {c['inconsistent_nams']}")
        logger.info(f"Tried NAM rescue: {c['nam_rescue']}")
        logger.info(f"Mates rescued by alignment: {c['tot_rescued']}")
        tm = (pipeline.engine.timers() if hasattr(pipeline, "engine")
              else pipeline.timers())
        if tm:
            logger.info(
                "Phase times: seeding+NAMs %.2f s, phase A total %.2f s, "
                "host alignment %.2f s, pairing+output %.2f s"
                % (tm["seed_nam_s"], tm["phase_a_s"], tm["host_align_s"],
                   tm["phase_b_s"])
            )
        return

    aligner = Aligner(aln_params)
    statistics = AlignmentStatistics()
    isize_est = InsertSizeDistribution()
    random_engine = MinstdRand(0)
    cigar_ops = CIGAR_OPS_EQX if opt.cigar_eqx else CIGAR_OPS_M

    if use_tpu:
        from ..ops.batch_extend import BatchAligner

        batch_aligner = BatchAligner(aln_params, getattr(opt, "tpu_batch", 512))
    else:
        from ..ops.batch_extend import HostBatchAligner

        batch_aligner = HostBatchAligner(aln_params)

    from .batched import phase_a_chunk, phase_b_chunk

    n_reads = 0
    t0 = time.perf_counter()
    pending = None  # (work, token, engine, paf_out) of the previous chunk

    def finish(prev):
        work, token, engine, paf_out = prev
        infos = batch_aligner.collect(token)
        sam = Sam(
            references, cigar_ops, opt.read_group_id, opt.output_unmapped,
            opt.details,
        )
        phase_b_chunk(
            work, infos, sam, statistics, isize_est, aligner, map_param,
            index_parameters, references, engine,
        )
        if map_param.is_sam_out:
            out.write(sam.take().encode())
        else:
            out.write("".join(paf_out).encode())

    # Software pipelining across chunks, mirroring the reference's worker
    # schedule (src/pc.cpp:1206-1510): the device extends chunk i while the
    # host finishes chunk i-1 and seeds chunk i+1. Each chunk has its own
    # RNG engine seeded with the chunk index (the reference's
    # random_engine/pre_random_engine pair, src/pc.cpp:583,706,801).
    for chunk_index, records1, records2, records3 in input_buffer.chunks():
        engine = MinstdRand(0)
        engine.seed(chunk_index)
        paf_out: List[str] = []
        work, n = phase_a_chunk(
            records1, records2, records3, paf_out, isize_est, aligner,
            batch_aligner, map_param, index_parameters, references, index,
            engine,
        )
        n_reads += n
        token = batch_aligner.dispatch()
        if pending is not None:
            finish(pending)
        pending = (work, token, engine, paf_out)
    if pending is not None:
        finish(pending)

    statistics.n_reads = n_reads
    statistics.tot_aligner_calls = aligner.calls_count()
    elapsed = time.perf_counter() - t0
    logger.info(f"Mapped {n_reads} reads in {elapsed:.2f} s "
                f"({n_reads / max(elapsed, 1e-9):.0f} reads/s)")
    logger.info(f"Total mapping sites tried: {statistics.tot_all_tried}")
    logger.info(f"Total calls to ssw: {statistics.tot_aligner_calls}")
    logger.info(f"Inconsistent NAM ends: {statistics.inconsistent_nams}")
    logger.info(f"Tried NAM rescue: {statistics.nam_rescue}")
    logger.info(f"Mates rescued by alignment: {statistics.tot_rescued}")
