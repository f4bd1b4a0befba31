#!/usr/bin/env python
"""Isolation experiment for in-process phase-A inflation: does the same
C++ phase A run slower inside a process that dispatches device work than
standalone, and which ingredient causes it?

Run one MODE per process (fresh interpreter = clean thread/heap state):
  host    - engine only; jax imported (package import) but backend never
            initialized, no device work at all
  jaxinit - backend initialized + resident pages uploaded, but mapping
            runs host-only (no dispatches)
  device  - full production path (as bench.py)

Usage: python tests/sanitize/inflate_exp.py MODE [n_passes]
Prints per-pass elapsed + engine phase timers.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import bench  # noqa: E402  (bench.py helpers: dataset + index)


def main():
    mode = sys.argv[1]
    n_passes = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    import os
    import tempfile

    from rabbitsalign_tpu.align.aligner import AlignmentParameters
    from rabbitsalign_tpu.map.common import MappingParameters
    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline

    genome = bench.np_genome(1_000_000, 1234)
    refs, params, index = bench.build_index(genome, "chr1")
    tmp = tempfile.mkdtemp(prefix="rsb_exp_", dir="/tmp")
    se_path = os.path.join(tmp, "se.fq")
    bench.write_fastq(se_path, bench.simulate_se(genome, bench.N_SE_READS), "r")

    aln_params = AlignmentParameters()
    map_param = MappingParameters(r=bench.READ_LEN)
    map_param.rescue_cutoff = min(map_param.rescue_level * index.filter_cutoff, 1000)

    on_device = mode == "device"
    if mode == "jaxinit":
        import jax

        from rabbitsalign_tpu.native.engine import NativeEngine
        from rabbitsalign_tpu.ops.extend_device import pack_ref_pages

        print(f"devices: {jax.devices()}", file=sys.stderr)
        eng = NativeEngine(index, params, refs, aln_params, map_param, "")
        pages = jax.device_put(pack_ref_pages(eng.ref_codes()))
        pages.block_until_ready()
        del eng

    sink = []
    # warmup pass
    warm = NativePipeline(index, params, refs, aln_params, map_param,
                          use_device=on_device)
    warm.map_file(se_path, "", False, 4000, sink.append)

    for i in range(n_passes):
        pipe = NativePipeline(index, params, refs, aln_params, map_param,
                              use_device=on_device)
        t0 = time.perf_counter()
        n = pipe.map_file(se_path, "", False, 4000, sink.append)
        dt = time.perf_counter() - t0
        t = pipe.engine.timers()
        print(f"{mode}[{i}]: {n} reads {dt:.3f}s ({n/dt:,.0f} r/s) "
              f"seed_nam={t['seed_nam_s']:.3f} phaseA={t['phase_a_s']:.3f} "
              f"hostalign={t['host_align_s']:.3f} phaseB={t['phase_b_s']:.3f}")

    import shutil

    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
