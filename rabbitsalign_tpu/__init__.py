"""rabbitsalign_tpu — a short-read DNA alignment engine on JAX.

A from-scratch reimplementation of the capabilities of RabbitSAlign
(a GPU-accelerated strobealign fork): syncmer/randstrobe seeding,
strobemer hash index, NAM chaining, batched affine-gap Smith-Waterman
extension, paired-end rescue/pairing and SAM/PAF output — with the
extend phase running on the accelerator (a CUDA kernel on NVIDIA GPUs,
an XLA program on CPU) and the data-parallel mapping step shardable over
a `jax.sharding.Mesh`.

The host-side layer reproduces the reference semantics bit-exactly
(`.sti` index interop, concordant SAM output).
"""

# 64-bit integers are required throughout (randstrobe hashes are uint64).
# This must run before any jax.numpy array is created.
import os as _os
from pathlib import Path as _Path

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set (jax
# reads it itself), else one fixed place in the checkout (the path is
# part of the cache key, so it must not move between runs); listed in
# .gitignore.
CHECKOUT_CACHE_DIR = str(_Path(__file__).resolve().parent.parent / ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"

# Version string mirrors the role of reference src/version.cpp
def version_string() -> str:
    return __version__
