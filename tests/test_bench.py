"""bench.py harness sanity: config table well-formed, every config's scene
loads, and the protocol frame-count resolution honors overrides.

The timed paths themselves run only on a GPU (bench.py refuses anything
else); what CAN break silently on CPU is the config table —
a renamed scene, a typo'd key, a frames count that isn't a positive
multiple of the chain — so pin exactly that here.
"""

import importlib.util
import os
import sys

import pytest

_BENCH = os.path.join(os.path.dirname(__file__), "..", "bench.py")


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    # bench.main() is never called: importing only defines CONFIGS/helpers.
    sys.modules["bench"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_every_config_scene_loads(bench):
    from terminal_raytracer.models import load_scene

    for name, cfg in bench.CONFIGS.items():
        scene = load_scene(cfg["scene"]).with_overrides(
            width=cfg.get("width"),
            height=cfg.get("height"),
            samples_per_pixel=cfg.get("spp"),
            max_depth=cfg.get("depth"),
        )
        assert scene.width > 0 and scene.height > 0, name
        assert scene.primitives, name


def test_protocol_frame_counts(bench):
    for name, cfg in bench.CONFIGS.items():
        frames = bench._frames_for(name, None)
        assert frames > 0, name
        chain = cfg.get("chain")
        if chain:
            # The chained runner times frames//chain whole chunks; a
            # non-multiple would silently time fewer frames than quoted.
            assert frames % int(chain) == 0, name


def test_frames_override_wins(bench):
    assert bench._frames_for("north_star", 48) == 48
    assert bench._frames_for("north_star", None) == \
        bench.CONFIGS["north_star"]["frames"]


def test_dynamic_configs_use_animatable_scenes(bench):
    """Dynamic configs go through pack_scene + the orbit animator; make
    sure the packing accepts every dynamic config's scene."""
    from terminal_raytracer.models import load_scene
    from terminal_raytracer.models.animate import orbit
    from terminal_raytracer.ops.dynamic import pack_scene

    for name, cfg in bench.CONFIGS.items():
        if not cfg.get("dynamic"):
            continue
        scene = load_scene(cfg["scene"]).with_overrides(
            samples_per_pixel=cfg.get("spp"), max_depth=cfg.get("depth")
        )
        arrays = orbit(pack_scene(scene), 3)
        assert arrays, name


def test_busy_ns_is_the_union_of_intervals(bench):
    """The trace reduction's busy time: overlaps count once, gaps not."""
    assert bench.busy_ns([]) == 0
    assert bench.busy_ns([(0, 10), (5, 10), (30, 5), (31, 1)]) == 20
    assert bench.busy_ns([(30, 5), (0, 40)]) == 40


def test_shard_takes_only_per_frame_static_configs(bench):
    for name in ("demo", "scan100", "dynamic"):
        with pytest.raises(SystemExit, match="per-frame static"):
            bench.run_bench(name, "jnp", 1, 1, False, shard="px:2")
