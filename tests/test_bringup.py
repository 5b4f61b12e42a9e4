"""What keeps the GPU bring-up honest without a card: the smoke script
refuses to run without a GPU, the compile cache follows its path rule,
the shard layout asks the device for its memory, and native libraries
are keyed by their source."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_the_cpu():
    r = _smoke(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the program, the script cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _smoke(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_compile_cache_uses_the_environment_dir(monkeypatch, tmp_path):
    import jax
    from nvbio_tpu.utils import jax_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_cache.cache_dir() == str(tmp_path)
    assert jax_cache.enable_compilation_cache() == str(tmp_path)
    # the environment variable is JAX's own: no other dir is set
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_the_checkout(monkeypatch):
    from nvbio_tpu.utils import jax_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = jax_cache.cache_dir()
    assert d == os.path.join(ROOT, ".scratch", "jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".scratch/" in f.read().split()


class _Dev:
    def __init__(self, platform, stats):
        self.platform, self._stats = platform, stats

    def memory_stats(self):
        return self._stats


def test_device_bytes_limit_raises_when_unreported():
    from nvbio_tpu.models.mesh_sharded import device_bytes_limit

    with pytest.raises(ValueError, match="reports no memory limit"):
        device_bytes_limit(_Dev("gpu", None))
    with pytest.raises(ValueError):
        device_bytes_limit(_Dev("gpu", {"bytes_in_use": 1}))


def test_device_bytes_limit_reads_the_device():
    import jax
    from nvbio_tpu.models.mesh_sharded import device_bytes_limit

    assert device_bytes_limit(_Dev("gpu", {"bytes_limit": 60 << 30})) \
        == 60 << 30
    # CPU devices share the host's memory
    assert device_bytes_limit(jax.devices("cpu")[0]) > 1 << 30


def test_native_library_is_keyed_by_its_source(tmp_path):
    from nvbio_tpu import native

    src = tmp_path / "lib.cpp"
    src.write_text("int f() { return 1; }\n")
    a = native._so_path(str(src), ["-O3"])
    assert a == native._so_path(str(src), ["-O3"])
    assert a != native._so_path(str(src), ["-O2"])
    src.write_text("int f() { return 2; }\n")
    assert a != native._so_path(str(src), ["-O3"])
    assert os.path.basename(a).startswith("_lib.")


def test_importing_the_package_claims_no_device():
    """Index-build pool workers import the package; an import that
    initialized a JAX backend would make each worker claim the card."""
    code = (
        "import importlib, pkgutil, nvbio_tpu\n"
        "import jax._src.xla_bridge as xb\n"
        "for m in pkgutil.walk_packages(nvbio_tpu.__path__, 'nvbio_tpu.'):\n"
        "    importlib.import_module(m.name)\n"
        "    assert not xb._backends, m.name\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_card_name_off_the_gpu():
    import jax
    from nvbio_tpu.utils.device import card_name

    assert card_name(jax.devices("cpu")[0]) == "cpu:cpu"
