"""Pod-mode (PodShardedIndex) overhead measurement.

Runs the SAME 48k-read SE workload at 40 Mbp three ways:
  1. single   — one process, full index, plain pipeline
  2. pod1     — one process "pod" (shard machinery on, all keys local):
                isolates the RunFeed + routing overhead from the wire
  3. pod2     — two OS processes, each holding HALF the index (full
                host arrays emptied), remote keys over the TCP side
                channel with the concurrent fan-out

When the processes share the host's cores, pod2's combined throughput
UPPER-BOUNDS protocol overhead (two python runtimes + the
server threads steal from each other); on a real multi-host deployment
the per-process work is what scales. Reported per variant: reads/s
(reads / max process wall), remote round-trips, keys and bytes per
chunk, from the PodShardedIndex wire telemetry.

Run: python tests/sanitize/pod_bench.py [n_reads]
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, ".")

from tests.util import free_port as _free_port  # noqa: E402
from tests.util import write_synthetic_se_fastq  # noqa: E402


def main():
    import bench

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 48000
    genome = bench.np_genome(int(40e6), 4321)
    d = "/tmp/pod_bench"
    os.makedirs(d, exist_ok=True)
    ref_fa = os.path.join(d, "ref.fa")
    if not os.path.exists(ref_fa):
        with open(ref_fa, "wb") as f:
            f.write(b">chr21\n")
            f.write(genome if isinstance(genome, bytes) else genome.encode())
            f.write(b"\n")
    gs = genome.decode() if isinstance(genome, bytes) else genome
    fq = os.path.join(d, f"reads_{n_reads}.fq")
    if not os.path.exists(fq):
        write_synthetic_se_fastq(fq, gs, n_reads)
    # PE set (half as many pairs = same read count): the PE path's
    # rescue preflight drives the remote lookup traffic hardest
    pe1 = os.path.join(d, f"pe1_{n_reads}.fq")
    pe2 = os.path.join(d, f"pe2_{n_reads}.fq")
    if not os.path.exists(pe1):
        gb = genome if isinstance(genome, bytes) else genome.encode()
        r1, r2 = bench.simulate_pe(gb, n_reads // 2, 17)
        bench.write_fastq(pe1, r1, "p")
        bench.write_fastq(pe2, r2, "p")

    worker = os.path.join("tests", "multihost_worker.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["RSB_POD_CHUNK"] = "8000"

    def run_pod(nprocs, shard, paired=False):
        coord = f"127.0.0.1:{_free_port()}"
        peers = ",".join(f"127.0.0.1:{_free_port()}"
                         for _ in range(nprocs))
        out_base = os.path.join(
            d, f"out_{nprocs}_{int(shard)}_{int(paired)}.sam")
        args_tail = (["shard", peers] if shard else [])
        reads = [pe1, pe2] if paired else [fq, ""]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, worker, coord, str(nprocs), str(pid), ref_fa,
             reads[0], reads[1], out_base] + args_tail,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd="/root/repo") for pid in range(nprocs)]
        walls, stats = [], None
        for p in procs:
            out, err = p.communicate(timeout=1200)
            assert p.returncode == 0, err.decode()[-2000:]
            o = out.decode()
            walls.append(float(o.split("WALL ", 1)[1].split()[0]))
            stats = json.loads(o.split("STATS ", 1)[1])
        total = time.perf_counter() - t0
        return walls, stats, total

    print(f"{n_reads} reads (SE + PE variants), 40 Mbp index, chunk 8000",
          file=sys.stderr)
    for tag, nprocs, shard, paired in (
            ("single   ", 1, False, False), ("pod1     ", 1, True, False),
            ("pod2     ", 2, True, False), ("single-pe", 1, False, True),
            ("pod2-pe  ", 2, True, True)):
        walls, stats, total = run_pod(nprocs, shard, paired)
        rps = stats["reads"] / max(walls)
        line = (f"{tag}: {rps:,.0f} reads/s (map wall max={max(walls):.2f}s "
                f"sum={sum(walls):.2f}s; incl. index build total={total:.1f}s)")
        if shard and stats.get("pod_lookup_batches"):
            nb = stats.get("pod_remote_batches", 0)
            line += (f"  lookups: {stats['pod_lookup_batches']:.0f} batches "
                     f"{stats['pod_lookup_keys']:.0f} keys; remote: "
                     f"{nb:.0f} round-trips "
                     f"{stats.get('pod_remote_keys', 0):.0f} keys "
                     f"tx={stats.get('pod_tx_bytes', 0) / 1e6:.1f}MB "
                     f"rx={stats.get('pod_rx_bytes', 0) / 1e6:.1f}MB")
        print(line)


if __name__ == "__main__":
    main()
