"""Test harness: single-process multi-device CPU mesh.

Reference analogue: tests run against an "N JVMs on localhost" cloud via
``water.runner.H2ORunner`` + ``@CloudSize(n)`` (SURVEY.md §4). Here the cloud
is 8 virtual XLA CPU devices in one process — the sharding/collective code
paths are identical to a real TPU slice.
"""

import os

# Force CPU before any backend initializes: the test tier always runs on the
# virtual 8-device CPU mesh, even when a real TPU is attached. (The config
# calls below are authoritative; the env vars cover subprocesses.)
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:
    # jax < 0.5.3 has no jax_num_cpu_devices; the XLA_FLAGS
    # --xla_force_host_platform_device_count set above covers it
    pass

# NOTE: the persistent compilation cache is deliberately NOT enabled for
# the CPU test tier: XLA:CPU AOT executables serialized here carry machine
# feature sets (prefer-no-scatter et al.) that mismatch the host at load
# time and intermittently SIGSEGV in compilation_cache.get/put_executable.
# The TPU bench keeps its own cache (bench.py) where entries are TPU AOT.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def mesh():
    from h2o3_tpu.parallel.mesh import default_mesh

    m = default_mesh()
    assert m.devices.size == 8, f"expected 8 virtual devices, got {m.devices.size}"
    return m


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "leaks_keys: legacy test/module exempt from the strict DKV "
        "key-leak check (keys are still swept after the test)",
    )
    config.addinivalue_line(
        "markers",
        "slow: excluded from the tier-1 run (-m 'not slow'): multi-node "
        "formation tests and other long-wall-clock coverage",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written kernels "
        "have no CPU mode); skips without one",
    )


def _sweep_keys(keys):
    from h2o3_tpu.keyed import DKV

    DKV.unlock_all()
    for k in keys:
        try:
            DKV.remove(k)
        except Exception:
            pass


@pytest.fixture(autouse=True)
def _check_dkv_keys(request):
    """CheckKeysTask analogue (h2o-test-support/.../runner/
    CheckKeysTask.java): every test must leave the DKV exactly as it
    found it. Keys created and not removed FAIL the test (and are swept
    so one failure cannot cascade). Tests/modules marked ``leaks_keys``
    are exempt — their state persists (module-scoped fixtures share
    keys) and the module-level sweeper below cleans up at module end."""
    from h2o3_tpu.keyed import DKV
    from h2o3_tpu.models.framework import Job

    before = set(DKV.keys())
    yield
    # Jobs persist by design: the /3/Jobs listing is the history of past
    # work (reference: Job keys are CheckKeysTask-exempt the same way)
    leaked = sorted(
        k for k in set(DKV.keys()) - before
        if not isinstance(DKV.peek(k), Job)
    )
    if leaked and request.node.get_closest_marker("leaks_keys") is None:
        _sweep_keys(leaked)
        pytest.fail(
            f"DKV key leak: {len(leaked)} key(s) left behind "
            f"(CheckKeysTask): {leaked[:10]}{'...' if len(leaked) > 10 else ''}"
        )


@pytest.fixture(scope="module", autouse=True)
def _sweep_dkv_between_modules():
    """Whatever a module's tests/fixtures accumulated (including marked
    leaks_keys debt) is removed at module end, so no module ever sees
    another module's keys."""
    from h2o3_tpu.keyed import DKV

    before = set(DKV.keys())
    yield
    _sweep_keys(sorted(set(DKV.keys()) - before))


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    Without this, the suite accumulates hundreds of live XLA:CPU
    executables in one process and intermittently SIGSEGVs inside a later
    backend_compile_and_load (JIT code-memory exhaustion — reproducible at
    ~90+ heavy compiles regardless of which tests ran). The reference
    suite runs as many separate JVMs; one long-lived Python process needs
    the explicit release."""
    yield
    jax.clear_caches()
