"""The extend program for NVIDIA GPUs: forward DP, traceback and
run-length encoding in one CUDA kernel (ops/cuda/sw_extend.cu), called
through the XLA foreign function interface.

The library is compiled with nvcc for sm_90a (Hopper) at first use, into
``build/cuda/`` of the checkout, under a name keyed on the sources' hash.
The same per-lane arithmetic is also built for the host with g++
(ops/cuda/sw_extend_host.cc), so tests without a GPU check it against
the XLA twin byte for byte.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .extend_device import OUT_ROWS
from .sw_jax import SwParams

_SRC = Path(__file__).resolve().parent / "cuda"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "cuda"
_HEADERS = ("sw_extend.cuh",)
WARP = 32
ROWS_PER_LANE = (1, 2, 4, 5, 8, 12, 16)  # = the R instantiated in the .cuh
TARGET = "rsa_sw_extend"

_lock = threading.Lock()
_registered = False
_host_lib = None


def rows_per_lane(Q: int) -> int:
    """Query rows each of a warp's 32 lanes holds (sw_extend.cuh
    rows_per_lane); the kernel takes query buckets up to 512."""
    for r in ROWS_PER_LANE:
        if WARP * r >= Q:
            return r
    raise ValueError(f"query bucket {Q} exceeds the kernel's 512 rows")


def scratch_shape(Q: int, T: int, B: int):
    """Direction scratch the kernel writes: one plane of Q+T-1 diagonals
    by 32*R padded query rows per pair."""
    return (B, (Q + T - 1) * WARP * rows_per_lane(Q))


def _build(src: str, compiler: list, suffix: str) -> Path:
    """Compile ops/cuda/<src> into build/cuda/, reusing an existing
    library whose name carries the same source hash."""
    h = hashlib.sha1()
    for name in (src,) + _HEADERS:
        h.update((_SRC / name).read_bytes())
    h.update(" ".join(compiler).encode())
    out = _BUILD / f"{Path(src).stem}-{h.hexdigest()[:12]}{suffix}"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cmd = compiler + ["-I", str(_SRC), str(_SRC / src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the GPU extend kernel needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_cuda_library() -> Path:
    return _build("sw_extend.cu", [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
    ], ".so")


def register() -> None:
    """Build (once per source hash) and register the FFI target."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build_cuda_library()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.RsaSwExtend), platform="CUDA")
        _registered = True


def extend_body(q_t, t_t, qlen, tlen, params: SwParams, sub: int):
    """(Q, B)/(T, B) u8 codes + (B,) lengths -> packed (OUT_ROWS, B) u8,
    byte-identical to extend_portable.extend_body. One launch covers the
    whole batch (`sub` is the twin's memory bound; the kernel needs
    none). The FFI target must be registered (extend_device.extend_program
    does that)."""
    del sub
    Q, B = q_t.shape
    T = t_t.shape[0]
    out, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((OUT_ROWS, B), jnp.uint8),
         jax.ShapeDtypeStruct(scratch_shape(Q, T, B), jnp.uint8)),
    )(q_t.T, t_t.T, qlen.astype(jnp.int32), tlen.astype(jnp.int32),
      match=np.int32(params.match), mismatch=np.int32(params.mismatch),
      gap_open=np.int32(params.gap_open),
      gap_extend=np.int32(params.gap_extend))
    return out


extend_body.label = "CUDA kernel (sm_90a)"


def extend_host_emulated(q_t, t_t, qlen, tlen, params: SwParams):
    """The kernel's arithmetic run on the host (numpy in, numpy out), with
    the same operand layout extend_body hands the FFI call."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            path = _build("sw_extend_host.cc",
                          ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"],
                          ".so")
            lib = ctypes.CDLL(str(path))
            lib.rsa_sw_extend_host.restype = ctypes.c_int
            lib.rsa_sw_extend_host.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            _host_lib = lib
    Q, B = q_t.shape
    T = t_t.shape[0]
    q = np.ascontiguousarray(np.asarray(q_t, np.uint8).T)
    t = np.ascontiguousarray(np.asarray(t_t, np.uint8).T)
    ql = np.ascontiguousarray(qlen, np.int32)
    tl = np.ascontiguousarray(tlen, np.int32)
    out = np.zeros((OUT_ROWS, B), np.uint8)
    rc = _host_lib.rsa_sw_extend_host(
        q.ctypes.data, t.ctypes.data, ql.ctypes.data, tl.ctypes.data, B, Q, T,
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        out.ctypes.data)
    if rc != 0:
        raise ValueError(f"query bucket {Q} exceeds the kernel's 512 rows")
    return out
