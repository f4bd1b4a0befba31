#!/usr/bin/env python
"""Smoke run of the aligner on an NVIDIA GPU, through the CLI a user runs.

    python chip_smoke.py                   # one GPU, 40 Mbp genome
    python chip_smoke.py --genome-mb 3000  # the same at GRCh38 scale
    python chip_smoke.py --compare-twin    # + SE end to end, CUDA vs XLA twin
    python chip_smoke.py --four            # only the 4-GPU path (needs 4 GPUs)

Default phases, in one process that owns the card:

1. refuse (exit 1, no result line) unless JAX's first device is a GPU;
   print its kind, the device count and nvidia-smi's name and power limit;
2. run the tests marked `gpu` (the CUDA extend kernel against the XLA twin
   and the host-traceback golden at every bucket width, byte for byte) and
   time both programs per bucket in device us/pair;
3. build bench.py's PE-40Mbp data from fixed seeds (genome, 24k 2x150
   pairs, 48k SE reads) and the index with all host cores (`-i`);
4. map SE and PE through `cli.main` with device extension and with
   `--no-tpu`; the SAM must be byte-identical (the @PG line aside) and
   the device must have extended more than zero pairs;
5. map PE again with `--device-seed` and with `--shard-index`: each SAM
   must equal the device run's;
6. print reads/s of the device runs, peak device memory and set-up times.

`--four` runs only the multi-device path: SE and PE with extend batches
round-robined over every local GPU (each holding its own genome copy) and
with `--shard-index` over a mesh of all of them, each byte-compared with
the host run; in the SE runs every GPU must have run extend dispatches.

Any failed phase raises, so the script exits non-zero without the last
line. On success the last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cli(argv, name):
    """Run the CLI in this process; returns its stderr log. A non-zero
    exit raises with the log's tail."""
    from rabbitsalign_tpu.cli import main as cli_main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main([str(a) for a in argv])
    text = err.getvalue()
    with open(os.path.join(WORK, f"{name}.log"), "w") as f:
        f.write(text)
    if rc != 0:
        raise RuntimeError(f"{name}: CLI exited {rc}\n{text[-3000:]}")
    log(f"  {name}: {time.perf_counter() - t0:.2f} s wall")
    for pattern in (r"Mapped \d+ reads in .*", r"Phase times: .*"):
        m = re.search(pattern, text)
        if m:
            log(f"    {m.group(0)}")
    return text


def logged(pattern, text, name):
    m = re.search(pattern, text)
    if m is None:
        raise RuntimeError(f"{name}: no line matching {pattern!r} in its log")
    return m


def sam_body(path):
    """SAM bytes without the @PG line (it holds the command line)."""
    with open(path, "rb") as f:
        return b"".join(l for l in f if not l.startswith(b"@PG"))


def same_sam(a, b, what):
    if sam_body(a) != sam_body(b):
        raise AssertionError(f"{what}: SAM differs ({a} vs {b})")
    log(f"  {what}: SAM byte-identical")


def make_data(genome_mb: float, threads: int):
    """bench.py's PE-40Mbp data at `genome_mb`, written as FASTA/FASTQ,
    then indexed by the CLI. Contigs of ~125 Mbp let the index build use
    every thread at genome scale."""
    import bench

    t0 = time.perf_counter()
    n = int(genome_mb * 1e6)
    genome = bench.np_genome(n, 4321)
    n_contigs = max(1, round(genome_mb / 125))
    ref = os.path.join(WORK, "ref.fa")
    with open(ref, "wb") as f:
        for i in range(n_contigs):
            lo, hi = i * n // n_contigs, (i + 1) * n // n_contigs
            f.write(b">chr%d\n" % (i + 1))
            f.write(genome[lo:hi])
            f.write(b"\n")
    se = os.path.join(WORK, "se.fq")
    bench.write_fastq(se, bench.simulate_se(genome, bench.N_SE_READS), "r")
    r1, r2 = bench.simulate_pe(genome, bench.N_PE_PAIRS)
    p1, p2 = os.path.join(WORK, "r1.fq"), os.path.join(WORK, "r2.fq")
    bench.write_fastq(p1, r1, "p")
    bench.write_fastq(p2, r2, "q")
    del genome, r1, r2
    log(f"  data: {genome_mb:g} Mbp genome in {n_contigs} contig(s), "
        f"{bench.N_SE_READS} SE reads, {bench.N_PE_PAIRS} pairs "
        f"({time.perf_counter() - t0:.1f} s)")
    cli(["-i", "--no-sidecar", "-r", 150, "-t", threads, ref], "index")
    return ref, se, p1, p2


def kernel_phase():
    """The marked GPU tests, then per-bucket device time of the CUDA
    kernel and of the XLA twin."""
    import jax
    import numpy as np
    import pytest

    from rabbitsalign_tpu.ops import extend_cuda
    from rabbitsalign_tpu.ops.extend_device import (
        extend_batch_packed,
        extend_program,
        pack_input,
    )
    from rabbitsalign_tpu.ops.extend_portable import extend_body as twin
    from rabbitsalign_tpu.ops.sw_jax import SwParams

    t0 = time.perf_counter()
    cuda = extend_program("gpu")
    log(f"  setup: CUDA library build + register "
        f"{time.perf_counter() - t0:.2f} s ({extend_cuda.build_cuda_library().name})")

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    count = Count()
    os.environ["RABBITSALIGN_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_ops.py")],
                     plugins=[count])
    if rc != 0 or count.passed < 4:
        raise AssertionError(f"gpu tests: exit {rc}, {count.passed} passed")
    log(f"  gpu tests: {count.passed} passed (CUDA == XLA twin, every byte)")

    rng = np.random.RandomState(0)
    sw = SwParams(2, 8, 12, 1)
    for Q, T, B in ((152, 256, 1024), (256, 512, 512), (256, 1536, 512),
                    (512, 2048, 512)):
        # reads of 100-150 bp planted in their windows with 3% mismatches
        q = rng.randint(0, 4, (Q, B)).astype(np.uint8)
        t = rng.randint(0, 4, (T, B)).astype(np.uint8)
        ql = np.minimum(rng.randint(100, 151, B), Q).astype(np.int32)
        tl = np.minimum(ql + rng.randint(0, 110, B), T).astype(np.int32)
        for i in range(B):
            st = rng.randint(0, tl[i] - ql[i] + 1)
            t[st:st + ql[i], i] = np.where(
                rng.rand(ql[i]) < 0.03, rng.randint(0, 4, ql[i]), q[:ql[i], i])
        q[np.arange(Q)[:, None] >= ql[None, :]] = 4
        t[np.arange(T)[:, None] >= tl[None, :]] = 4
        buf = jax.device_put(pack_input(q, t, ql, tl))
        line = []
        for name, body, reps in (("cuda", cuda, 20), ("xla twin", twin, 5)):
            extend_batch_packed(buf, Q, T, sw, body).block_until_ready()
            ts = []
            for _ in range(reps):
                t1 = time.perf_counter()
                extend_batch_packed(buf, Q, T, sw, body).block_until_ready()
                ts.append(time.perf_counter() - t1)
            med = sorted(ts)[len(ts) // 2]
            line.append(f"{name} {med / B * 1e6:.3f} us/pair")
        log(f"  extend ({Q},{T})x{B}: " + ", ".join(line)
            + " (median, device-resident input)")


def mapping_phase(ref, se, p1, p2, threads):
    idx = ["--use-index", "-r", 150, "-t", threads, "--deterministic"]
    out = lambda name: os.path.join(WORK, f"{name}.sam")  # noqa: E731
    rates = {}
    for name, reads in (("se", [se]), ("pe", [p1, p2])):
        text = cli(idx + ["-o", out(name + "_dev"), ref] + reads, name + "_dev")
        pairs = int(logged(r"Device-extended pairs: (\d+)", text, name).group(1))
        rates[name] = float(logged(r"\((\d+) reads/s\)", text, name).group(1))
        ready = logged(r"Extend programs ready after a further ([\d.]+) s",
                       text, name).group(1)
        log(f"  {name}_dev: {pairs} device-extended pairs, {rates[name]:.0f} "
            f"reads/s, extend programs ready {ready} s after the index")
        if pairs <= 0:
            raise AssertionError(f"{name}: the device extended no pairs")
        cli(idx + ["--no-tpu", "-o", out(name + "_host"), ref] + reads,
            name + "_host")
        same_sam(out(name + "_dev"), out(name + "_host"), f"{name} device vs host")
    for flag in ("--device-seed", "--shard-index"):
        name = "pe_" + flag.strip("-").replace("-", "_")
        text = cli(idx + [flag, "-o", out(name), ref, p1, p2], name)
        log(f"  {name}: {logged(r'Device-extended pairs: (\d+)', text, name).group(1)}"
            f" device-extended pairs, "
            f"{logged(r'\((\d+) reads/s\)', text, name).group(1)} reads/s")
        same_sam(out(name), out("pe_dev"), f"pe {flag} vs device")
    return rates


def compare_twin_phase(ref, se, threads):
    """SE end to end through the threaded pipeline with each extend
    program, interleaved (cuda, twin, twin, cuda, cuda, twin)."""
    from rabbitsalign_tpu.align.aligner import AlignmentParameters
    from rabbitsalign_tpu.index.params import IndexParameters
    from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu.io.fasta import References
    from rabbitsalign_tpu.map.common import MappingParameters
    from rabbitsalign_tpu.ops.extend_device import extend_program
    from rabbitsalign_tpu.ops.extend_portable import extend_body as twin
    from rabbitsalign_tpu.pipeline.native_pipeline import ThreadedNativePipeline

    refs = References.from_fasta(ref)
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.read(ref + params.filename_extension())
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(mp.rescue_level * index.filter_cutoff, 1000)
    bodies = {"cuda": extend_program("gpu"), "xla twin": twin}
    outs, rates = {}, {k: [] for k in bodies}
    for name in ("cuda", "xla twin", "xla twin", "cuda", "cuda", "xla twin"):
        pipe = ThreadedNativePipeline(
            index, params, refs, ap, mp, n_workers=threads,
            deterministic=True, kernel=bodies[name])
        sink = []
        t0 = time.perf_counter()
        n = pipe.map_file(se, "", False, 10000, sink.append)
        rates[name].append(n / (time.perf_counter() - t0))
        outs.setdefault(name, b"".join(sink))
    if outs["cuda"] != outs["xla twin"]:
        raise AssertionError("SE output differs between CUDA and XLA twin")
    for name, r in rates.items():
        log(f"  SE end to end, {name}: " + ", ".join(f"{x:.0f}" for x in r)
            + f" reads/s (first is warm-up; {threads} workers)")


def four_phase(ref, se, p1, p2, threads):
    import jax

    from rabbitsalign_tpu.pipeline import native_pipeline as npl

    devices = jax.local_devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
    counts, lock = {}, threading.Lock()
    orig = npl.NativePipeline._dispatch

    def spy(self, buf, Q, T, sub):
        res = orig(self, buf, Q, T, sub)
        (dev,) = res.devices()
        with lock:
            counts[dev] = counts.get(dev, 0) + 1
        return res

    npl.NativePipeline._dispatch = spy
    idx = ["--use-index", "-r", 150, "-t", threads, "--deterministic"]
    out = lambda name: os.path.join(WORK, f"{name}.sam")  # noqa: E731
    for data, reads in (("se", [se]), ("pe", [p1, p2])):
        cli(idx + ["--no-tpu", "-o", out(data + "_host"), ref] + reads,
            data + "_host")
        for flag in ([], ["--shard-index"]):
            name = data + "_dev" + "".join(
                "_" + f.strip("-").replace("-", "_") for f in flag)
            counts.clear()
            text = cli(idx + flag + ["-o", out(name), ref] + reads, name)
            per = [counts.get(d, 0) for d in devices]
            log(f"  {name}: dispatches per GPU {per}, "
                f"{logged(r'\((\d+) reads/s\)', text, name).group(1)} reads/s")
            # SE has thousands of gapped jobs, PE-40Mbp only a few batches
            if data == "se" and min(per) < 1:
                raise AssertionError(f"{name}: a GPU ran no extend dispatch: {per}")
            same_sam(out(name), out(data + "_host"), f"{name} vs host")
    npl.NativePipeline._dispatch = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=float, default=40.0)
    ap.add_argument("--compare-twin", action="store_true")
    ap.add_argument("--four", action="store_true")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import rabbitsalign_tpu  # noqa: F401  (fails outside a checkout)

    log(f"device: {dev.device_kind}, {len(jax.devices())} device(s), "
        f"platform {dev.platform}")
    log(nvidia_smi())  # name, power limit: one line per GPU
    threads = min(16, os.cpu_count() or 1)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_start = time.perf_counter()
    try:
        if not args.four:
            log("phase: kernel")
            kernel_phase()
        log("phase: data + index")
        ref, se, p1, p2 = make_data(args.genome_mb, threads)
        if args.four:
            log("phase: four GPUs")
            four_phase(ref, se, p1, p2, threads)
        else:
            log("phase: mapping (SE, PE; device vs host; --device-seed, "
                "--shard-index)")
            rates = mapping_phase(ref, se, p1, p2, threads)
            log(f"  reads/s (device, {threads} workers): SE {rates['se']:.0f},"
                f" PE {rates['pe']:.0f}")
            if args.compare_twin:
                log("phase: SE end to end, CUDA kernel vs XLA twin")
                compare_twin_phase(ref, se, threads)
        for d in jax.local_devices():
            log(f"  peak device memory {d}: "
                f"{d.memory_stats()['peak_bytes_in_use'] / 2**30:.2f} GiB")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
