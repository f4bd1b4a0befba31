"""CPU-side checks of the GPU smoke script and the compile-cache
placement: what a run without a card must show."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """Without a GPU (or without the rest of the checkout) chip_smoke.py
    exits non-zero before doing any work and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=_cpu_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compilation_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set and the package then sets
    no directory of its own; unset, the cache sits at the one fixed,
    git-ignored path in the checkout."""
    import rabbitsalign_tpu

    env = _cpu_env()
    env["PYTHONPATH"] = REPO
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = rabbitsalign_tpu.CHECKOUT_CACHE_DIR
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import rabbitsalign_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == want
    assert want == str(tmp_path / "cache") or want == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_one_place_sets_the_cache_dir():
    """Only the package's __init__ sets jax_compilation_cache_dir."""
    setters = []
    for root, _, files in os.walk(os.path.join(REPO, "rabbitsalign_tpu")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if '"jax_compilation_cache_dir"' in f.read():
                        setters.append(os.path.relpath(path, REPO))
    assert setters == [os.path.join("rabbitsalign_tpu", "__init__.py")]
