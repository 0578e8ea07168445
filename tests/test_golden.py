"""Golden-image tests: low-res deterministic-seed accumulated renders of
all three shipped scenes vs committed reference images (SURVEY.md §4.4).
Same seed + same CPU backend => near-exact; the tolerance absorbs XLA
fusion/version drift, while structural regressions (geometry, lighting,
tonemap, accumulation) blow way past it."""

from pathlib import Path

import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.runtime.offline import render_accumulated
from terminal_raytracer.utils.imageio import read_ppm

GOLDEN = Path(__file__).parent / "golden"


@pytest.mark.parametrize("name", ["Cornell_Box", "demo", "scene2"])
def test_golden_image(name):
    scene = load_scene(name).with_overrides(
        width=96, height=48, samples_per_pixel=8, max_depth=4
    )
    _, rgb, _, rays = render_accumulated(
        scene, Camera().pose(), n_frames=4, seed=1234,
        full_color=True, backend="jnp",
    )
    want = read_ppm(GOLDEN / f"{name}_96x48.ppm")
    assert rgb.shape == want.shape
    diff = np.abs(rgb.astype(np.int32) - want.astype(np.int32))
    assert diff.mean() < 1.0, f"mean abs diff {diff.mean():.2f}"
    assert (diff > 8).mean() < 0.01, f"{(diff > 8).mean():.3%} pixels off by >8"
    assert rays > 0
