"""Test harness: run everything on the CPU backend with 8 virtual devices.

The multi-card sharding tests use an 8-way CPU-device mesh — the JAX-native
analog of a fake collective backend (SURVEY.md §4.6). The backend is forced
via jax.config before anything initializes it.

Card-only tests carry the `gpu` marker and skip without a GPU (the `gpu`
fixture decides, at run time). On the card they run with
`python -m pytest tests/ -m gpu`, which leaves JAX on its default (GPU)
platform; chip_smoke.py runs them.

CI sharding: TEST_SHARD=i/n (e.g. "0/4") selects a deterministic subset of
test FILES per job so the workflow splits the suite across parallel runners.
Files shard as whole units (module-level fixtures and XLA compile caches
stay coherent), assigned by greedy longest-first balancing over MEASURED
per-file runtimes (_WEIGHTS, minutes) — deterministic for a fixed file set;
files without a weight get a median default.
"""

import os

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere "
        "(run on the card: python -m pytest tests/ -m gpu)")
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (python -m pytest tests/ -m gpu "
                    "on the card)")
    return jax.devices()[0]


# Measured per-file serial runtimes (minutes, full-suite junit on a 1-core
# box — relative weights are what the balancer needs).
_WEIGHTS = {
    "test_pallas.py": 9.08, "test_arrayscene.py": 6.26,
    "test_parallel.py": 5.54, "test_denoise.py": 4.27,
    "test_accel.py": 3.71, "test_dynamic.py": 3.32, "test_mis.py": 2.98,
    "test_dielectric.py": 2.93, "test_fuzz.py": 2.61, "test_fog.py": 2.22,
    "test_chunk.py": 2.12, "test_texture.py": 1.82,
    "test_render_step.py": 1.79, "test_checker.py": 1.45,
    "test_cli.py": 1.44, "test_roughness.py": 1.42, "test_mesh.py": 1.34,
    "test_normalmap.py": 1.24, "test_parity.py": 1.02,
    "test_gathered.py": 1.02, "test_offline.py": 0.85, "test_sky.py": 0.79,
    "test_sampler.py": 0.79, "test_dof.py": 0.73, "test_unbiased.py": 0.46,
    "test_resume.py": 0.44, "test_golden.py": 0.42, "test_safety.py": 0.35,
    "test_tonemap.py": 0.34, "test_energy.py": 0.13,
    "test_sampling.py": 0.04, "test_rng.py": 0.03, "test_geometry.py": 0.03,
    "test_vecmath.py": 0.01, "test_bench.py": 0.01, "test_scene.py": 0.01,
    "test_blit.py": 0.01, "test_camera.py": 0.01, "test_grid.py": 0.01,
}
_DEFAULT_WEIGHT = 0.8  # unweighted (new) files: ~median


def _shard_of(fnames, n):
    """Greedy longest-first balancing: deterministic for a fixed file set."""
    order = sorted(fnames, key=lambda f: (-_WEIGHTS.get(f, _DEFAULT_WEIGHT), f))
    load = [0.0] * n
    owner = {}
    for f in order:
        s = min(range(n), key=lambda i: (load[i], i))
        owner[f] = s
        load[s] += _WEIGHTS.get(f, _DEFAULT_WEIGHT)
    return owner


def pytest_collection_modifyitems(config, items):
    shard = os.environ.get("TEST_SHARD")
    if not shard:
        return
    idx, n = (int(x) for x in shard.split("/"))
    fnames = sorted({os.path.basename(str(item.fspath)) for item in items})
    owner = _shard_of(fnames, n)
    keep, drop = [], []
    for item in items:
        fname = os.path.basename(str(item.fspath))
        (keep if owner[fname] == idx else drop).append(item)
    items[:] = keep
    config.hook.pytest_deselected(items=drop)
