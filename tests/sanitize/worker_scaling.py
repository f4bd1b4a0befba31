"""Worker-scaling overhead bound: the per-worker COST of the threaded
pipeline. Pinned to one core (taskset -c 0), N workers do constant useful
work, so any wall increase over the
single-pipeline run is pure orchestration overhead (producer thread,
bounded queues, ordered merge, GIL crossings, per-worker engine state).
A multicore deployment scales the useful work per core and pays exactly
this overhead per worker.

Runs host-only (no device) so the jax client threads don't add noise;
the production device path overlaps dispatch with host work and its
contention is measured separately (tests/sanitize/inflate_exp.py).

Run: python tests/sanitize/worker_scaling.py [n_reads]
"""

import os
import sys
import time

sys.path.insert(0, ".")


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import bench
    from rabbitsalign_tpu.align.aligner import AlignmentParameters
    from rabbitsalign_tpu.index.params import IndexParameters
    from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu.io.fasta import References
    from rabbitsalign_tpu.map.common import MappingParameters
    from rabbitsalign_tpu.pipeline.native_pipeline import (
        NativePipeline,
        ThreadedNativePipeline,
    )

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 48000
    genome = bench.np_genome(int(40e6), 4321)
    refs = References()
    refs.add("chr21",
             genome if isinstance(genome, bytes) else genome.encode())
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)

    gs = genome.decode() if isinstance(genome, bytes) else genome
    d = "/tmp/worker_scaling"
    os.makedirs(d, exist_ok=True)
    fq = os.path.join(d, f"reads_{n_reads}.fq")
    if not os.path.exists(fq):
        from tests.util import write_synthetic_se_fastq

        write_synthetic_se_fastq(fq, gs, n_reads)

    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(mp.rescue_level * index.filter_cutoff, 1000)

    def run(n_workers, trials=3):
        best = 1e18
        out_ref = None
        for _ in range(trials):
            if n_workers == 0:
                pipe = NativePipeline(index, params, refs, ap, mp,
                                      use_device=False)
            else:
                pipe = ThreadedNativePipeline(
                    index, params, refs, ap, mp, use_device=False,
                    n_workers=n_workers)
            sink = []
            t0 = time.perf_counter()
            n = pipe.map_file(fq, "", False, 8000, sink.append)
            w = time.perf_counter() - t0
            best = min(best, w)
            out = b"".join(sink)
            if out_ref is None:
                out_ref = out
            assert out == out_ref, f"N={n_workers}: output diverged"
            assert n == n_reads
        return best, out_ref

    base, golden = run(0)
    print(f"{n_reads} SE reads, 40 Mbp index, chunk 8000, host-only, "
          f"best-of-3", file=sys.stderr)
    print(f"single pipeline : {base:5.2f}s  {n_reads/base:>9,.0f} reads/s "
          f"(baseline)")
    for nw in (1, 2, 4):
        w, out = run(nw)
        assert out == golden, f"N={nw}: output != single-pipeline golden"
        ovh = (w - base) / base * 100
        print(f"workers N={nw}     : {w:5.2f}s  {n_reads/w:>9,.0f} reads/s "
              f"(orchestration overhead {ovh:+.1f}% vs single; "
              f"{(w-base)/nw*1e3/max(1,n_reads/8000):+.1f} ms/worker/chunk)")


if __name__ == "__main__":
    main()
