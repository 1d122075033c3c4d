"""The persistent compile cache: env var honoured, else a fixed path."""

import os

import jax
import pytest

from gappadder.utils import jaxcache


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path, monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    if env_set:
        monkeypatch.setenv(jaxcache.ENV, str(tmp_path))
        assert jaxcache.setup_compile_cache() == str(tmp_path)
        assert updates == []          # JAX reads the variable itself
    else:
        monkeypatch.delenv(jaxcache.ENV, raising=False)
        got = jaxcache.setup_compile_cache()
        assert got == jaxcache.REPO_CACHE
        assert os.path.basename(got) == ".jax_cache"
        assert os.path.isdir(os.path.join(os.path.dirname(got),
                                          "gappadder"))
        assert updates == [("jax_compilation_cache_dir", got)]
