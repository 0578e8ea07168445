"""runtime/compare.py on the CPU: the agreement check that bench.py's gate
and chip_smoke.py run on the card."""

import jax
import numpy as np
import pytest

from terminal_raytracer.models import load_scene
from terminal_raytracer.runtime import compare as cmp


def test_kernel_interpreter_agrees_exactly_with_oracle():
    scene = load_scene("Cornell_Box").with_overrides(
        width=40, height=6, samples_per_pixel=8, max_depth=4)
    a = cmp.render_once(scene, "pallas", interpret=True)
    b = cmp.render_once(scene, "jnp", device=jax.devices("cpu")[0])
    res = cmp.compare(a, b, cmp.KERNEL_VS_JNP)
    assert res["ok"], res
    assert res["budget_mismatch_share"] == 0.0 and res["rays_rel"] == 0.0


@pytest.mark.parametrize("tol", [cmp.KERNEL_VS_JNP, cmp.CARD_VS_CPU],
                         ids=["kernel_vs_jnp", "card_vs_cpu"])
def test_disagreement_is_flagged(tol):
    rng = np.random.RandomState(0)
    rad = rng.rand(3, 10, 10).astype(np.float32)
    tot = np.full((10, 10), 4.0, np.float32)
    ref = (rad, tot, 1000.0)
    assert cmp.compare(ref, ref, tol)["ok"]
    flipped = tot.copy()
    flipped[:2] = 8.0  # 20% of pixels took another adaptive budget
    res = cmp.compare((rad, flipped, 1000.0), ref, tol)
    assert not res["ok"]
    assert abs(res["budget_mismatch_share"] - 0.2) < 1e-6
    assert not cmp.compare((rad, tot, 1100.0), ref, tol)["ok"]  # rays +10%
    # image mean +10%
    assert not cmp.compare((rad * 1.1, tot, 1000.0), ref, tol)["ok"]
    nan = rad.copy()
    nan[0, 0, 0] = np.nan
    assert not cmp.compare((nan, tot, 1000.0), ref, tol)["ok"]


def test_lost_block_is_flagged():
    """One 128-pixel kernel block lost at north-star size (400x200) breaks
    the kernel-vs-jnp budget limit; at the card-vs-CPU size (128x64) it
    breaks that one."""
    for (h, w), tol in (((200, 400), cmp.KERNEL_VS_JNP),
                        ((64, 128), cmp.CARD_VS_CPU)):
        rad = np.full((3, h, w), 0.5, np.float32)
        tot = np.full((h, w), 4.0, np.float32)
        lost_rad, lost_tot = rad.copy(), tot.copy()
        lost_rad[:, 0, :128] = 0.0
        lost_tot[0, :128] = 0.0
        res = cmp.compare((lost_rad, lost_tot, 1000.0), (rad, tot, 1000.0),
                          tol)
        assert not res["ok"], res
