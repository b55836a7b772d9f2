"""Platform plumbing: the compilation-cache rule and full f32 precision of
the sampler's data products."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from basicrta_tpu import jax_cache


def test_cache_honours_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets nothing."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert jax_cache.enable_compilation_cache() == "/some/cache"
    assert calls == []


def test_cache_defaults_to_checkout(monkeypatch):
    """Without it, the cache is the fixed <checkout>/.jax_cache."""
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = jax_cache.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_collapsed_sweep_products_at_highest_precision():
    """T_k = values @ counts is data: it must not run in TF32 on a GPU."""
    from basicrta_tpu.config import GibbsConfig
    from basicrta_tpu.sampler.kernels import (collapsed_sweep,
                                              init_mixture_params)
    cfg = GibbsConfig(ncomp=3)
    v = jnp.asarray(np.linspace(0.1, 5.0, 16), jnp.float32)
    c = jnp.ones((16,), jnp.float32)
    closed = jax.make_jaxpr(
        lambda k: collapsed_sweep(k, init_mixture_params(3), v, c,
                                  cfg)[0])(jax.random.key(0))

    def dots(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn.params["precision"]
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    found = list(dots(closed.jaxpr))
    assert found and all(p == (jax.lax.Precision.HIGHEST,) * 2
                         for p in found), found
