"""Platform independence: engine choice, cache placement, card-only smoke.

Nothing in the package branches on the platform name: the acquisition
engine resolves the same way for any device, the compile caches follow
``JAX_COMPILATION_CACHE_DIR`` or stay inside the checkout, and the
on-card smoke script refuses to run anywhere but a GPU.
"""

import os
import subprocess
import sys
import types

import jax
import pytest

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.dist import shard
from tpu_gnss.receiver import Receiver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_auto_engine_ignores_platform(platform, monkeypatch):
    fake = types.SimpleNamespace(platform=platform, device_kind="fake")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [fake])
    assert Receiver(SMALL)._resolve_engine() == "refined"


def test_auto_engine_shards_on_mesh():
    mesh = shard.make_mesh(4, axes=("dop",))
    assert Receiver(SMALL, mesh=mesh)._resolve_engine() == "refined_sharded"


_PROBE = """
import jax
from tpu_gnss.utils import jaxcache, progcache
jaxcache.enable_persistent_cache()
print(jax.config.jax_compilation_cache_dir)
print(progcache._DIR)
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_placement(env_set, tmp_path):
    """Both caches live under $JAX_COMPILATION_CACHE_DIR when it is set,
    else under <checkout>/.jax_cache — never in the home directory."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp_path / "home"))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_set:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    xla_dir, exported = r.stdout.split()[-2:]
    assert xla_dir == want
    assert exported == os.path.join(want, "exported")
    assert os.path.isdir(exported)
    assert not os.path.exists(tmp_path / "home")


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits non-zero and prints no
    result line; it never carries on on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
