"""The persistent compilation cache's directory rule (utils/cache.py):
``JAX_COMPILATION_CACHE_DIR`` decides when set; otherwise one fixed,
gitignored directory inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each case runs in a fresh interpreter: the cache directory is process
# global JAX config, which must not leak into the other tests
PROBE = (
    "import jax; from odesat_tpu.utils.cache import enable_compilation_cache as e; "
    "d = e(); print(repr(d)); print(repr(jax.config.jax_compilation_cache_dir))"
)


def _probe(env_updates):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "ODESAT_NO_CACHE", "ODESAT_CACHE_DIR")}
    env.update(env_updates)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env, capture_output=True, text=True,
        check=True,
    ).stdout.splitlines()
    return eval(out[-2]), eval(out[-1])  # noqa: S307 — our own repr output


def test_default_is_the_fixed_directory_in_the_checkout():
    used, configured = _probe({})
    assert used == configured == os.path.join(REPO, ".jax_cache")


def test_env_var_decides_and_nothing_else_is_set(tmp_path):
    used, configured = _probe({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert used == str(tmp_path)
    # JAX reads the variable itself; the program sets no other directory
    assert configured == str(tmp_path)


@pytest.mark.parametrize("value", ["1", "yes"])
def test_no_cache_disables(value):
    used, configured = _probe({"ODESAT_NO_CACHE": value})
    assert used is None and not configured


def test_removed_knob_is_ignored(tmp_path):
    """ODESAT_CACHE_DIR is gone: it no longer moves the cache."""
    used, _ = _probe({"ODESAT_CACHE_DIR": str(tmp_path)})
    assert used == os.path.join(REPO, ".jax_cache")


def test_cache_directory_is_gitignored():
    with open(os.path.join(REPO, ".gitignore"), encoding="utf-8") as fh:
        assert ".jax_cache/" in fh.read().split()


def test_default_directory_does_not_depend_on_process_or_time():
    from odesat_tpu.utils.cache import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert str(os.getpid()) not in DEFAULT_CACHE_DIR
