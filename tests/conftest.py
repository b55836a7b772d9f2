"""Test harness: a virtual 8-device CPU platform.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) and must exercise
multi-device sharding; an 8-way host-platform device count provides a real
``jax.sharding.Mesh`` for the sharded code paths. Kernels compiled for the
GPU run here in the Pallas interpreter.

Tests that need the card are marked ``gpu`` and take the ``gpu`` fixture,
which skips them elsewhere. On a machine with a GPU run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

_ON_CARD = "cuda" in os.environ.get("JAX_PLATFORMS", "")
if not _ON_CARD:
    # XLA_FLAGS must be in the environment before the CPU backend is
    # first created
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, jax.devices()
# no persistent compilation cache: CLI tests call cli.main(), which would
# otherwise share one cache directory between concurrent test workers
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_compiled_code():
    """Free compiled executables between test modules.

    A full single-process suite run accumulates every module's jitted
    programs (the interpret-mode Pallas segment graphs are large) and
    reproducibly SEGFAULTS inside XLA:CPU's compiler near the end of the
    run — the same files pass in any half-suite combination. Dropping
    references lets the loaded code be reclaimed and keeps the process
    under whatever code-memory threshold the crash sits at, at the cost
    of cross-module recompiles."""
    yield
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is an NVIDIA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    return jax.devices()[0]


@pytest.fixture
def rng(request):
    """Per-test deterministic RNG, independent of suite ordering.

    A session-scoped generator makes each test's draws depend on which
    tests ran before it — statistical assertions then flake only in
    specific suite compositions. Seeding from the test id keeps every
    test's stream fixed forever.
    """
    import zlib
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


@pytest.fixture(scope="session")
def synthetic_times():
    """Discretized hyperexponential dataset with known parameters."""
    from basicrta_tpu.ops.surv import simulate_hyperexp, discretize_times
    weights = np.array([0.85, 0.13, 0.02])
    rates = np.array([4.0, 0.2, 0.01])
    x = simulate_hyperexp(20000, weights, rates,
                          np.random.default_rng(12345))
    return discretize_times(x, 0.1), weights, rates
