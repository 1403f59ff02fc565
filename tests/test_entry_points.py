"""Entry-point plumbing: the compile-cache rule, and chip_smoke.py's
contract off the card (no GPU: non-zero exit, no result line)."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from cadrays_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_cache_dir_honours_environment():
    env = {compile_cache.ENV_VAR: "/somewhere/else"}
    assert compile_cache.cache_dir(env) == "/somewhere/else"


def test_cache_dir_default_is_fixed_inside_checkout():
    a = compile_cache.cache_dir({})
    assert a == compile_cache.cache_dir({}) == os.path.join(ROOT,
                                                            ".jax_cache")
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: ""}) == a
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_configure_sets_nothing_when_environment_names_a_dir(monkeypatch,
                                                             tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_result_line_is_exactly_the_contract():
    line = chip_smoke.result_line({"platform": "gpu",
                                   "kind": "NVIDIA H100 80GB HBM3",
                                   "count": 1, "extra": "dropped"})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_require_gpu_refuses_cpu():
    from cadrays_tpu.utils.device import describe, require_gpu

    assert describe()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()
