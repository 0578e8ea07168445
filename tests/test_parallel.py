"""Multi-chip sharding on an 8-way virtual CPU mesh (conftest.py forces
jax_num_cpu_devices=8 — the JAX-native fake-collective backend of
SURVEY.md §4.6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.parallel import make_mesh, make_sharded_render_step
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def _scene(**kw):
    d = dict(width=64, height=32, samples_per_pixel=4, max_depth=3)
    d.update(kw)
    return load_scene("scene2").with_overrides(**d)


def test_pixel_sharding_matches_single_chip():
    scene = _scene()
    mesh = make_mesh(n_px=4, n_sp=1)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp")
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))

    ref_step = make_render_step(scene, backend="jnp")
    ref = ref_step(init_state(scene), POSE, np.uint32(5), np.int32(0))

    np.testing.assert_allclose(
        np.asarray(out.state.acc), np.asarray(ref.state.acc), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(out.rgb), np.asarray(ref.rgb))
    assert float(out.rays) == float(ref.rays)


def test_pixel_sharding_lays_out_rows():
    scene = _scene()
    mesh = make_mesh(n_px=8, n_sp=1)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp")
    state = mk_state()
    # acc [3, H, W] must be sharded along H over 'px'
    shard_shapes = {s.data.shape for s in state.acc.addressable_shards}
    assert shard_shapes == {(3, 4, 64)}
    out = step(state, POSE, np.uint32(1), np.int32(0))
    assert out.rgb.shape == (32, 64, 3)


def test_sample_split_matches_single_chip_semantics():
    """sp=2 reproduces single-chip adaptive-sampling statistics exactly:
    variance/budget from ALL base samples via psum, global
    normalization. The comparison target is therefore the single-chip
    FULL-spp render (same estimator incl. the sum(base)/spp quirk), equal up
    to RNG decorrelation."""
    scene = _scene(samples_per_pixel=8)
    mesh = make_mesh(n_px=4, n_sp=2)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp")
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))
    acc = np.asarray(out.state.acc)
    assert np.isfinite(acc).all() and acc.shape == (3, 32, 64)

    # Per-pixel sample totals follow the single-chip budget formula applied
    # to the *merged* variance: total = base + min(spp-base, floor(var*50))
    # iff var > 10 (shader.wgsl:561-562).
    var = np.asarray(out.state.variance)
    samples = np.asarray(out.state.samples)
    base, spp = 4.0, 8.0
    expect = base + np.where(
        var > 10.0, np.minimum(spp - base, np.floor(var * 50.0)), 0.0
    )
    np.testing.assert_array_equal(samples, expect)

    # Statistical agreement with the single-chip full-spp render (same
    # estimator, decorrelated RNG).
    ref = make_render_step(scene, backend="jnp")(
        init_state(scene), POSE, np.uint32(5), np.int32(0)
    )
    assert abs(acc.mean() - np.asarray(ref.state.acc).mean()) < 0.05


def test_sample_split_pallas_matches_jnp():
    """The sample split runs its phases on the jnp path (the megakernel
    fuses both phases, leaving no seam for the psum between them):
    backend='auto' resolves to it on every platform, bit-identically."""
    scene = _scene(width=128, height=8, samples_per_pixel=8, max_depth=2)
    mesh = make_mesh(n_px=2, n_sp=2)
    step_a, mk_a = make_sharded_render_step(scene, mesh, backend="auto")
    step_j, mk_j = make_sharded_render_step(scene, mesh, backend="jnp")
    assert step_a.backend == step_j.backend == "jnp"
    a = step_a(mk_a(), POSE, np.uint32(9), np.int32(0))
    b = step_j(mk_j(), POSE, np.uint32(9), np.int32(0))
    assert float(a.rays) == float(b.rays)
    np.testing.assert_array_equal(np.asarray(a.state.acc),
                                  np.asarray(b.state.acc))


def test_accumulation_across_frames_sharded():
    scene = _scene()
    mesh = make_mesh(n_px=2, n_sp=1)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp")
    out = step(mk_state(), POSE, np.uint32(1), np.int32(0))
    out = step(out.state, POSE, np.uint32(2), np.int32(1))
    ref_step = make_render_step(scene, backend="jnp")
    ref = ref_step(init_state(scene), POSE, np.uint32(1), np.int32(0))
    ref = ref_step(ref.state, POSE, np.uint32(2), np.int32(1))
    np.testing.assert_allclose(
        np.asarray(out.state.acc), np.asarray(ref.state.acc), atol=1e-6
    )


def test_indivisible_height_raises():
    scene = _scene(height=30)
    mesh = make_mesh(n_px=4, n_sp=1)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_render_step(scene, mesh)


def test_indivisible_base_budget_matches_single_chip_semantics():
    """spp=24 -> base = max(4, 24//4) = 6 splits over sp=4
    as unequal shares (2,2,1,1) via a runtime per-shard quota — no config
    is rejected. The merged estimator still follows the single-chip budget
    formula applied to the merged variance."""
    scene = _scene(samples_per_pixel=24)
    mesh = make_mesh(n_px=2, n_sp=4)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp")
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))
    acc = np.asarray(out.state.acc)
    assert np.isfinite(acc).all() and acc.shape == (3, 32, 64)

    var = np.asarray(out.state.variance)
    samples = np.asarray(out.state.samples)
    base, spp = 6.0, 24.0
    expect = base + np.where(
        var > 10.0, np.minimum(spp - base, np.floor(var * 50.0)), 0.0
    )
    np.testing.assert_array_equal(samples, expect)

    # Statistical agreement with the single-chip full-spp render (same
    # estimator, decorrelated RNG).
    ref = make_render_step(scene, backend="jnp")(
        init_state(scene), POSE, np.uint32(5), np.int32(0)
    )
    assert abs(acc.mean() - np.asarray(ref.state.acc).mean()) < 0.05


def test_indivisible_base_budget_pallas_matches_jnp():
    """backend='pallas' on a sample-split mesh is refused at build time
    (even in interpret mode) instead of silently running jnp; the jnp
    split reports no occupancy (-1)."""
    scene = _scene(width=128, height=8, samples_per_pixel=8, max_depth=2)
    mesh = make_mesh(n_px=1, n_sp=8)
    with pytest.raises(ValueError, match="sample-split"):
        make_sharded_render_step(scene, mesh, backend="pallas",
                                 interpret=True)
    step_j, mk_j = make_sharded_render_step(scene, mesh, backend="jnp")
    b = step_j(mk_j(), POSE, np.uint32(9), np.int32(0))
    assert np.isfinite(np.asarray(b.state.acc)).all()
    assert float(b.occupancy) == -1.0


def test_pallas_sharded_matches_jnp_sharded():
    """The row-offset-aware kernel inside shard_map (interpret mode on
    the CPU mesh) agrees with the XLA tracer shard path. spp=8 > base=4 so
    the adaptive extra phase runs too."""
    scene = _scene(width=128, height=16, samples_per_pixel=8, max_depth=2)
    mesh = make_mesh(n_px=2, n_sp=1)
    step_p, mk_p = make_sharded_render_step(scene, mesh, backend="pallas",
                                            interpret=True)
    step_j, mk_j = make_sharded_render_step(scene, mesh, backend="jnp")
    a = step_p(mk_p(), POSE, np.uint32(5), np.int32(0))
    b = step_j(mk_j(), POSE, np.uint32(5), np.int32(0))
    assert float(a.rays) == float(b.rays)
    np.testing.assert_allclose(
        np.asarray(a.state.acc), np.asarray(b.state.acc), atol=1e-6
    )
    assert 0.0 < float(a.occupancy) <= 1.0  # px-merged measured occupancy
    assert float(b.occupancy) == -1.0


def test_pixel_sharding_mis_transport():
    """The MIS transport composes with pixel-row sharding: the sharded
    step with transport='mis' reproduces the single-chip mis render
    exactly (pure DP — same RNG chains per pixel)."""
    scene = _scene()
    mesh = make_mesh(n_px=4, n_sp=1)
    step, mk_state = make_sharded_render_step(
        scene, mesh, backend="jnp", transport="mis"
    )
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))

    ref_step = make_render_step(scene, backend="jnp", transport="mis")
    ref = ref_step(init_state(scene), POSE, np.uint32(5), np.int32(0))
    np.testing.assert_allclose(
        np.asarray(out.state.acc), np.asarray(ref.state.acc), atol=1e-6
    )
    assert float(out.rays) == float(ref.rays)

    # and it is genuinely a different transport than the default
    base_step = make_render_step(scene, backend="jnp")
    base = base_step(init_state(scene), POSE, np.uint32(5), np.int32(0))
    assert not np.array_equal(
        np.asarray(out.state.acc), np.asarray(base.state.acc)
    )


# ---- Engine/CLI integration (--shard) ---------------------------------------


def test_parse_shard_specs():
    from terminal_raytracer.runtime.engine import _parse_shard

    assert _parse_shard("4") == (4, 1)
    assert _parse_shard("px:2") == (2, 1)
    assert _parse_shard("sp:2") == (1, 2)
    assert _parse_shard("px:2,sp:4") == (2, 4)
    assert _parse_shard("sp:4, px:2") == (2, 4)
    # Duplicate axes and bare-N-mixed-with-axis forms would silently
    # override each other — rejected outright.
    for bad in ("0", "px:1", "foo:2", "px:2,sp:x", "", "px:2,4",
                "px:2,px:8", "2,2"):
        with pytest.raises(ValueError):
            _parse_shard(bad)


def test_engine_shard_matches_single_chip():
    """Engine(shard='px:N') is the user-facing wrapper of the sharded step:
    pixel-row DP must reproduce the single-chip render bit-for-bit (same
    seed chain; global pixel coords per shard)."""
    from terminal_raytracer.runtime.engine import Engine

    scene = _scene()
    ref = Engine(scene, backend="jnp", deterministic=5)
    rgb_r, _g, rays_r, spp_r, _h = ref.run_headless(3, chunk=1)
    sh = Engine(scene, backend="jnp", deterministic=5, shard="px:4")
    rgb_s, _g, rays_s, spp_s, _h = sh.run_headless(3)
    assert float(rays_s) == float(rays_r)
    assert float(spp_s) == float(spp_r)
    np.testing.assert_array_equal(np.asarray(rgb_s), np.asarray(rgb_r))


def test_engine_shard_px_sp():
    """The full ('px','sp') mesh through the Engine: runs, accumulates, and
    draws the reference budget statistics (rays within the all-or-nothing
    budget band of the single-chip render)."""
    from terminal_raytracer.runtime.engine import Engine

    scene = _scene(samples_per_pixel=8)
    eng = Engine(scene, backend="jnp", deterministic=7, shard="px:2,sp:2")
    rgb, _g, rays, spp, _h = eng.run_headless(2)
    assert rgb.shape == (scene.height, scene.width, 3)
    assert float(rays) > 0 and np.isfinite(np.asarray(rgb)).all()
    assert eng.frame_count == 2


def test_engine_shard_rejections():
    from terminal_raytracer.runtime.engine import Engine

    scene = _scene()
    with pytest.raises(ValueError, match="unbiased"):
        Engine(scene, backend="jnp", shard="px:2", unbiased=True)
    with pytest.raises(ValueError, match="accel"):
        Engine(scene, backend="jnp", shard="px:2", accel="array")
    with pytest.raises(ValueError, match="devices"):
        Engine(scene, backend="jnp", shard="px:16")
    with pytest.raises(ValueError, match="chunking"):
        Engine(scene, backend="jnp", shard="px:2").run_headless(4, chunk=4)


def test_cli_shard_flag(capsys):
    """--shard through the real CLI entry point (headless, 8-dev CPU mesh),
    plus the flag-combination rejections."""
    from terminal_raytracer.cli import main

    rc = main(["--scene", "scene2", "--width", "64", "--height", "32",
               "--spp", "4", "--depth", "3", "--frames", "2",
               "--backend", "jnp", "--shard", "px:2"])
    assert rc == 0
    capsys.readouterr()
    for extra in (["--scan"], ["--turntable", "4", "--dump-image", "t%d.png"],
                  ["--unbiased"], ["--accel", "array"]):
        rc = main(["--scene", "scene2", "--frames", "2", "--shard", "px:2",
                   *extra])
        assert rc == 2, extra
    rc = main(["--scene", "scene2", "--frames", "1", "--shard", "bogus"])
    assert rc == 2
    # --animate composes with --shard since round 4 (the sharded step
    # carries the pack_scene values as replicated runtime inputs).
    rc = main(["--scene", "scene2", "--width", "64", "--height", "32",
               "--spp", "4", "--depth", "3", "--frames", "2",
               "--backend", "jnp", "--shard", "px:2", "--animate", "orbit"])
    assert rc == 0
    capsys.readouterr()


def test_dynamic_sharded_step_matches_single_chip():
    """Animated scenes on the mesh: px-sharded dynamic rendering is
    BIT-identical to the single-chip dynamic step; the px-sharded kernel
    (interpret mode) agrees with it exactly on ray counts (scheduler-
    independent); the sample-split axis renders finite images."""
    from terminal_raytracer.models.animate import ANIMATOR_KEYS, ANIMATORS
    from terminal_raytracer.ops.dynamic import pack_scene
    from terminal_raytracer.runtime import init_state, make_render_step

    scene = _scene()
    pose = Camera().pose()
    arrays = ANIMATORS["orbit"](pack_scene(scene), 3)
    keys = ANIMATOR_KEYS["orbit"]

    step1 = make_render_step(scene, full_color=True, backend="jnp",
                             dynamic=True, animated=keys)
    out1 = step1(init_state(scene), pose, np.uint32(9), np.int32(0), arrays)
    rays1 = float(jax.device_get(out1.rays))
    acc1 = np.asarray(jax.device_get(out1.state.acc))

    mesh = make_mesh(n_px=2, n_sp=1, devices=jax.devices()[:2])
    step, init = make_sharded_render_step(scene, mesh, backend="jnp",
                                          dynamic=True, animated=keys)
    out = step(init(), pose, np.uint32(9), np.int32(0), arrays)
    assert float(jax.device_get(out.rays)) == rays1
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(out.state.acc)), acc1)

    step_k, init_k = make_sharded_render_step(
        scene, mesh, backend="pallas", dynamic=True, animated=keys,
        interpret=True)
    out_k = step_k(init_k(), pose, np.uint32(9), np.int32(0), arrays)
    assert float(jax.device_get(out_k.rays)) == rays1
    np.testing.assert_allclose(
        np.asarray(jax.device_get(out_k.state.acc)), acc1, atol=2e-5)

    mesh22 = make_mesh(n_px=2, n_sp=2, devices=jax.devices()[:4])
    step, init = make_sharded_render_step(scene, mesh22, dynamic=True,
                                          animated=keys)
    out = step(init(), pose, np.uint32(9), np.int32(0), arrays)
    assert np.isfinite(np.asarray(jax.device_get(out.state.acc))).all()


def test_engine_shard_resumes_saved_state(tmp_path):
    """A --load-state checkpoint written by a single-chip engine restores
    into a sharded engine (jit shards the host arrays) and continues
    accumulation bit-identically to the single-chip resume."""
    from terminal_raytracer.runtime.engine import Engine
    from terminal_raytracer.utils.statefile import load_state, save_state

    scene = _scene()
    e1 = Engine(scene, backend="jnp", deterministic=3)
    e1.run_headless(2, chunk=1)
    p = str(tmp_path / "st.npz")
    save_state(p, e1.state, e1.frame_count, e1.camera)

    e2 = Engine(scene, backend="jnp", deterministic=3, shard="px:4")
    e2.state, e2.frame_count, e2.camera = load_state(
        p, expect_shape=(scene.height, scene.width))
    rgb2, _g, rays2, _s, _h = e2.run_headless(2)

    e3 = Engine(scene, backend="jnp", deterministic=3)
    e3.state, e3.frame_count, e3.camera = load_state(
        p, expect_shape=(scene.height, scene.width))
    rgb3, _g, rays3, _s, _h = e3.run_headless(2, chunk=1)
    assert float(rays2) == float(rays3)
    np.testing.assert_array_equal(np.asarray(rgb2), np.asarray(rgb3))


def test_sharded_display_flags_match_single_chip():
    """--tonemap/--exposure through the mesh step: the display transform
    applies after the psum'd accumulation, so the sharded rgb/glyphs must
    equal the single-chip step's under the same flags."""
    scene = _scene()
    mesh = make_mesh(n_px=4, n_sp=1)
    step, mk_state = make_sharded_render_step(
        scene, mesh, backend="jnp", full_color=False,
        tonemap="aces", exposure=1.0)
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))

    ref_step = make_render_step(scene, backend="jnp", full_color=False,
                                tonemap="aces", exposure=1.0)
    ref = ref_step(init_state(scene), POSE, np.uint32(5), np.int32(0))

    np.testing.assert_array_equal(np.asarray(out.rgb), np.asarray(ref.rgb))
    np.testing.assert_array_equal(
        np.asarray(out.glyphs), np.asarray(ref.glyphs))

    # And the displayed pixels actually differ from the reference curves.
    plain, mk2 = make_sharded_render_step(scene, mesh, backend="jnp",
                                          full_color=False)
    base = plain(mk2(), POSE, np.uint32(5), np.int32(0))
    assert (np.asarray(base.rgb) != np.asarray(out.rgb)).any()
