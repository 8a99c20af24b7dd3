"""Process-level behaviour: where the compile cache goes, and that the
on-card smoke test refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_updates, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in drop and k != "EPPM_NO_COMPILE_CACHE"}
    env.update(env_updates)
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=120)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; unset, the
    cache is the fixed <checkout>/.jax_cache."""
    code = (
        "import sys; sys.path.insert(0, %r); import eppm, jax; "
        "print(jax.config.jax_compilation_cache_dir)" % ROOT
    )
    want = str(tmp_path / "cc")
    updates = {"JAX_PLATFORMS": "cpu"}
    if env_set:
        updates["JAX_COMPILATION_CACHE_DIR"] = want
    out = _run(code, updates, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    got = out.stdout.strip().splitlines()[-1]
    if env_set:
        assert got == want
    else:
        assert got == os.path.join(ROOT, ".jax_cache")
        assert os.path.isdir(got)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """On the CPU, or copied away from the package, chip_smoke.py exits
    non-zero and prints no result line."""
    cwd = ROOT
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
        script = str(tmp_path / "chip_smoke.py")
    out = _run([sys.executable, script], {"JAX_PLATFORMS": "cpu"}, cwd=cwd,
               drop=("PYTHONPATH",))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
