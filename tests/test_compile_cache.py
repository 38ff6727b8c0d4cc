"""Where the persistent compilation cache goes (mp3tpu.ensure_compile_cache).

The backend is faked as a GPU and jax.config.update recorded, so the
tests see what the encoder would configure without touching the real
cache settings of this process.
"""
import os

import jax
import pytest

import mp3tpu


@pytest.fixture
def fake_backend(monkeypatch):
    """Returns (set_backend, updates): updates records every
    jax.config.update the cache setup makes."""
    updates = {}
    monkeypatch.setattr(mp3tpu, "_CACHE_DONE", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)

    def set_backend(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_backend, updates


def test_cache_follows_env_dir(monkeypatch, tmp_path, fake_backend):
    set_backend, updates = fake_backend
    set_backend("gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    mp3tpu.ensure_compile_cache()
    assert mp3tpu.compile_cache_dir() == str(tmp_path)
    # JAX reads the variable itself; the encoder sets no other directory
    assert "jax_compilation_cache_dir" not in updates


def test_cache_defaults_to_checkout(monkeypatch, fake_backend):
    set_backend, updates = fake_backend
    set_backend("gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    mp3tpu.ensure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(mp3tpu.__file__)))
    want = os.path.join(root, ".jax_cache")
    assert updates == {"jax_compilation_cache_dir": want}
    assert mp3tpu.compile_cache_dir() == want
    # once per process
    updates.clear()
    mp3tpu.ensure_compile_cache()
    assert updates == {}


def test_cache_stays_off_on_cpu(monkeypatch, fake_backend):
    set_backend, updates = fake_backend
    set_backend("cpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    mp3tpu.ensure_compile_cache()
    assert updates == {}
