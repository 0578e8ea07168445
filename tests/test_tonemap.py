"""Tonemap/quantization/glyph-index semantics vs reference lib.rs:509-524."""

import jax.numpy as jnp
import numpy as np

from terminal_raytracer.ops import tonemap as tm
from terminal_raytracer.ops.vecmath import V3


def _img(vals):
    a = jnp.asarray(np.array(vals, np.float32)).reshape(1, -1)
    return V3(a, a, a)


def test_ramp():
    assert len(tm.GLYPH_RAMP) == 68
    assert tm.GLYPH_RAMP[0] == " " and tm.GLYPH_RAMP[-1] == "$"
    assert tm.GLYPH_RAMP[1] == "." and tm.GLYPH_RAMP[27] == "\\"


def test_fullcolor_sqrt_gamma():
    acc = _img([0.0, 0.25, 1.0, 4.0])
    rgb = np.asarray(tm.tonemap_fullcolor(acc))
    # sqrt gamma: 0 -> 0, 0.25 -> 127 (0.5*255 truncated), 1 -> 255, 4 -> clamp 255
    np.testing.assert_array_equal(rgb[0, :, 0], [0, 127, 255, 255])
    assert rgb.dtype == np.uint8


def test_ascii_pow_gamma_and_luma():
    acc = _img([0.0, 0.5, 1.0])
    rgb, idx = tm.tonemap_ascii(acc)
    rgb, idx = np.asarray(rgb), np.asarray(idx)
    expected_c = np.clip((np.array([0.0, 0.5, 1.0]) ** 0.3) * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(rgb[0, :, 1], expected_c)
    # grey pixel: luma == value; index = trunc(min(luma^0.3 * 67, 67))
    expected_idx = np.minimum((np.array([0.0, 0.5, 1.0]) ** 0.3) * 67, 67).astype(np.uint8)
    np.testing.assert_array_equal(idx[0], expected_idx)


def test_luma_weights():
    r = V3(jnp.ones((1, 1)), jnp.zeros((1, 1)), jnp.zeros((1, 1)))
    _, idx_r = tm.tonemap_ascii(r)
    g = V3(jnp.zeros((1, 1)), jnp.ones((1, 1)), jnp.zeros((1, 1)))
    _, idx_g = tm.tonemap_ascii(g)
    # Green contributes more luma than red (0.7152 > 0.2126)
    assert np.asarray(idx_g).item() > np.asarray(idx_r).item()
    assert np.asarray(idx_r).item() == int(min(0.2126**0.3 * 67, 67))


def test_glyph_index_clamps_hdr():
    acc = _img([100.0])
    _, idx = tm.tonemap_ascii(acc)
    assert np.asarray(idx).item() == 67


def test_variance_heatmap():
    v = jnp.asarray(np.array([[0.0, 5.0, 100.0]], np.float32))
    hm = np.asarray(tm.variance_heatmap(v))
    assert hm.shape == (1, 3, 3) and hm.dtype == np.uint8
    assert hm[0, 0, 2] == 255 and hm[0, 0, 0] == 0  # cold = blue
    assert hm[0, 2, 0] == 255 and hm[0, 2, 2] == 0  # hot = red


# ----------------------------------------------------------------------
# Display-control extensions: --tonemap / --exposure (statically gated —
# the defaults must reproduce the reference math above bit-for-bit).
# ----------------------------------------------------------------------


def test_parse_mode():
    import pytest

    assert tm.parse_mode("reference") == "reference"
    assert tm.parse_mode("ACES ") == "aces"
    assert tm.parse_mode("gamma:2.2") == ("gamma", 2.2)
    assert tm.parse_mode(("gamma", 1.8)) == ("gamma", 1.8)
    for bad in ("filmic", "gamma:0", "gamma:-1", "gamma:x", ""):
        with pytest.raises(ValueError):
            tm.parse_mode(bad)


def test_default_args_bit_identical():
    acc = _img([0.0, 0.25, 0.5, 1.0, 4.0])
    np.testing.assert_array_equal(
        np.asarray(tm.tonemap_fullcolor(acc)),
        np.asarray(tm.tonemap_fullcolor(acc, "reference", 1.0)))
    r0, i0 = tm.tonemap_ascii(acc)
    r1, i1 = tm.tonemap_ascii(acc, "reference", 1.0)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_aces_curve_vs_numpy():
    x = np.linspace(0.0, 8.0, 64, dtype=np.float32)
    got = np.asarray(tm.aces(jnp.asarray(x)))
    want = np.clip(x * (2.51 * x + 0.03) / (x * (2.43 * x + 0.59) + 0.14),
                   0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # Monotonic, bounded, and filmic: compresses highlights below the
    # reference sqrt curve at high radiance.
    assert (np.diff(got) >= -1e-7).all() and got.max() <= 1.0
    rgb = np.asarray(tm.tonemap_fullcolor(_img([4.0]), "aces", 1.0))
    assert rgb[0, 0, 0] < 255  # sqrt mode clamps this to 255


def test_gamma_mode_vs_numpy():
    vals = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    rgb = np.asarray(tm.tonemap_fullcolor(_img(vals), ("gamma", 2.2), 1.0))
    want = np.clip((vals ** (1 / 2.2)) * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(rgb[0, :, 0], want)
    # ASCII glyph index follows the same curve of the luma.
    _, idx = tm.tonemap_ascii(_img(vals), ("gamma", 2.2), 1.0)
    want_idx = np.minimum((vals ** (1 / 2.2)) * 67, 67).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(idx)[0], want_idx)


def test_exposure_is_pre_tonemap_scale():
    vals = np.array([0.0, 0.1, 0.25, 0.5], np.float32)
    np.testing.assert_array_equal(
        np.asarray(tm.tonemap_fullcolor(_img(vals), "reference", 2.0)),
        np.asarray(tm.tonemap_fullcolor(_img(vals * 2.0))))
    r0, i0 = tm.tonemap_ascii(_img(vals), "aces", 4.0)
    r1, i1 = tm.tonemap_ascii(_img(vals * 4.0), "aces", 1.0)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_step_display_flags():
    """make_render_step threads --tonemap/--exposure; the defaults stay
    bit-identical to a step built with no display args at all."""
    import jax

    from terminal_raytracer.models import Camera, load_scene
    from terminal_raytracer.runtime import init_state, make_render_step

    scene = load_scene("Cornell_Box").with_overrides(
        width=64, height=32, samples_per_pixel=2, max_depth=3)
    pose = Camera().pose()

    def run(**kw):
        step = make_render_step(scene, full_color=False, backend="jnp", **kw)
        out = step(init_state(scene), pose, np.uint32(7), np.int32(0))
        return jax.device_get((out.rgb, out.glyphs, out.rays))

    rgb0, g0, rays0 = run()
    rgb1, g1, rays1 = run(tonemap="reference", exposure=0.0)
    np.testing.assert_array_equal(rgb0, rgb1)
    np.testing.assert_array_equal(g0, g1)
    assert rays0 == rays1

    rgb2, g2, rays2 = run(tonemap="aces", exposure=1.0)
    assert rays2 == rays0          # display-only: the estimator is untouched
    assert (rgb2 != rgb0).any()    # ...but the displayed pixels move
    assert (g2 != g0).any()


def test_cli_tonemap_flags():
    """--tonemap validation errors early; a good spec renders headless."""
    import pytest

    from terminal_raytracer import cli

    with pytest.raises(SystemExit):
        cli.main(["--scene", "Cornell_Box", "--tonemap", "bogus"])
    with pytest.raises(SystemExit):
        cli.main(["--scene", "Cornell_Box", "--tonemap", "gamma:0"])

    args = ["--width", "48", "--height", "16", "--spp", "2", "--depth", "2",
            "--backend", "jnp", "--scene", "scene2", "--deterministic", "3",
            "--frames", "1"]
    assert cli.main(args + ["--tonemap", "aces", "--exposure", "1"]) == 0
