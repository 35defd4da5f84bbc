"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding is validated on CPU via
``--xla_force_host_platform_device_count`` (SURVEY.md §4, §7.3).  JAX
is pinned to the CPU unless JAX_PLATFORMS names other platforms, as the
GPU parity tests (``-m gpu``) need.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Persistent compilation cache: the heavy e2e modules re-trace the same
# fused frame/BA/loop programs every run; cached executables cut
# repeat-run wall time substantially on the 2-core CI box.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache_cpu"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_between_modules():
    """Release compiled executables between test modules.

    A single `pytest tests/` invocation accumulates every module's
    compiled XLA programs (the r4 one-shot run died after ~55 min at
    >3.2 GB RSS — VERDICT r4 weak #8).  Compilation caches are pure
    caches: dropping them per module trades a little recompilation for
    a bounded footprint."""
    yield
    jax.clear_caches()
    gc.collect()
