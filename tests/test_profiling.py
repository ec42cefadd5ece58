"""Observability and start-up plumbing: the profiler context, the
compile-cache placement, and chip_smoke.py's refusal without a GPU."""

import json
import os
import subprocess
import sys

import pytest

from gvr.utils import compile_cache
from gvr.utils.profiling import device_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_trace_reraises_body_errors(tmp_path):
    """An error inside the traced body propagates unchanged (the context
    must not swallow it or yield a second time)."""
    with pytest.raises(RuntimeError, match="boom"):
        with device_trace(str(tmp_path)):
            raise RuntimeError("boom")


def test_device_trace_reraises_profiler_errors(tmp_path):
    """A profiler that cannot start (a second trace while one runs) is an
    error, not a silent untraced run."""
    with device_trace(str(tmp_path / "outer")):
        with pytest.raises(Exception):
            with device_trace(str(tmp_path / "inner")):
                pass


def test_device_trace_is_a_noop_without_dir():
    with device_trace(None):
        pass


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(tmp_path, monkeypatch, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the cache goes there; unset, it
    goes to the fixed <checkout>/.jax_cache."""
    import jax
    before = jax.config.jax_compilation_cache_dir
    want = str(tmp_path / "cc")
    if env_dir:
        monkeypatch.setenv(compile_cache.ENV, want)
    else:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    try:
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _smoke(cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """On a machine without a GPU the smoke run fails and prints no
    result line, in the checkout and as a lone copy of the script."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            with open(os.path.join(ROOT, "chip_smoke.py")) as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
        r = _smoke(str(cwd))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_chip_smoke_last_line_format(monkeypatch, capsys):
    """The result line is one JSON object with the device as JAX reports
    it; count is 4 for the four-card path."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(chip_smoke, "read_card", lambda: "H100, 700.00 W")
    monkeypatch.setattr(chip_smoke, "run_gpu_tests", lambda: None)
    monkeypatch.setattr(chip_smoke, "one_card", lambda card: True)
    monkeypatch.setattr(chip_smoke, "four_cards", lambda card: True)
    import jax
    monkeypatch.setattr(jax, "devices", lambda: [Dev()] * 4)
    from gvr.utils import compile_cache as cc
    monkeypatch.setattr(cc, "enable", lambda: "cache")
    for argv, count in ((["chip_smoke.py"], 4),
                        (["chip_smoke.py", "--four-cards"], 4)):
        monkeypatch.setattr(sys, "argv", argv)
        assert chip_smoke.main() == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert "H100, 700.00 W" in out[:-1]
        assert json.loads(out[-1]) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": count}}
    monkeypatch.setattr(chip_smoke, "one_card", lambda card: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out
