"""Stratified pixel-jitter sampler — capability extension tests.

`sampler: "stratified"` (models/scene.py) remaps each BASE-phase sample's
two sub-pixel jitter draws into cell i mod g^2 of a g x g grid
(ops/tracer.py stratify_jitter), with g^2 dividing the base count so the
aggregate cell coverage is exactly uniform (unbiased). Adaptive extras
keep the reference's independent jitter. Same contract as the other
extensions: statically gated — sampler 'reference' (the default) compiles
the exact reference jitter — and agreeing across every scheduler/backend
(the remap is shared jnp math keyed on the same absolute sample indices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.models import Camera
from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer

POSE = Camera().pose()


def _edge_scene(**overrides):
    """One bright emissive sphere against the gradient sky: edge pixels'
    jitter decides hit-vs-miss, the case stratification helps most."""
    cfg = {
        "width": 128, "height": 8, "samples_per_pixel": 16, "max_depth": 2,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [{"center": [0.0, 0.0, -3.0], "radius": 1.0,
                     "color": [0, 0, 0], "emission": [4.0, 4.0, 4.0],
                     "reflectivity": 0.0}],
    }
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


def _render(tracer, seed=42, frame=0):
    return jax.jit(tracer.render_frame)(POSE, np.uint32(seed),
                                        np.int32(frame))


# ---------------------------------------------------------------------------
# Schema / grid derivation
# ---------------------------------------------------------------------------


def test_schema_and_validation():
    s = _edge_scene()
    assert s.sampler == "reference"
    s2 = s.with_overrides(sampler="stratified")
    assert s2.sampler == "stratified"
    assert s.with_overrides().sampler == "reference"
    with pytest.raises(ValueError, match="sampler"):
        _edge_scene(sampler="sobol")
    assert _edge_scene(sampler="stratified").sampler == "stratified"


def test_grid_derivation():
    # g is the largest power of two with g^2 dividing base = max(4, spp/4).
    for spp, g in ((128, 4), (64, 4), (32, 2), (16, 2), (4, 2), (1, 2),
                   (20, 1)):  # spp=20 -> base=5: no even coverage, off
        t = PathTracer(_edge_scene(samples_per_pixel=spp,
                                   sampler="stratified"))
        assert t.strat_g == g, (spp, t.strat_g)
        assert t.base_samples % (t.strat_g ** 2) == 0
    # The default sampler is the static identity.
    assert PathTracer(_edge_scene()).strat_g == 1
    # A tracer given an explicit base_quota (a sample-split shard) falls
    # back to reference jitter — stratification is budget-global.
    t = PathTracer(_edge_scene(sampler="stratified"), base_quota=2)
    assert t.strat_g == 1


def test_stratify_jitter_cells_and_extras():
    t = PathTracer(_edge_scene(samples_per_pixel=128, sampler="stratified"))
    g = t.strat_g
    assert g == 4
    rx = jnp.full((4, 128), 0.5, jnp.float32)
    for s in range(t.base_samples):
        sx, sy = t.stratify_jitter(s, rx, rx)
        cx, cy = s % g, (s // g) % g
        np.testing.assert_allclose(np.asarray(sx), (cx + 0.5) / g, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(sy), (cy + 0.5) / g, rtol=1e-6)
        # In-cell bounds for extreme draws.
        lo, _ = t.stratify_jitter(s, jnp.zeros_like(rx), jnp.zeros_like(rx))
        hi, _ = t.stratify_jitter(s, jnp.full_like(rx, 0.999999),
                                  jnp.full_like(rx, 0.999999))
        assert float(lo[0, 0]) == pytest.approx(cx / g)
        assert float(hi[0, 0]) < (cx + 1) / g + 1e-6
    # Base coverage is exactly even: every cell hit base/g^2 times.
    cells = [(s % g, (s // g) % g) for s in range(t.base_samples)]
    from collections import Counter

    counts = Counter(cells)
    assert set(counts.values()) == {t.base_samples // (g * g)}
    # Extra-phase indices (>= base) keep the raw draw.
    ex, ey = t.stratify_jitter(t.base_samples, rx, rx)
    np.testing.assert_array_equal(np.asarray(ex), np.asarray(rx))
    np.testing.assert_array_equal(np.asarray(ey), np.asarray(rx))
    # Vector sample indices (the regen/stream schedulers) match scalars.
    sv = jnp.arange(4, dtype=jnp.int32)[:, None] * jnp.ones(
        (4, 128), jnp.int32)
    vx, vy = t.stratify_jitter(sv, rx, rx)
    for s in range(4):
        ssx, ssy = t.stratify_jitter(s, rx[s:s + 1], rx[s:s + 1])
        np.testing.assert_array_equal(np.asarray(vx[s]), np.asarray(ssx[0]))
        np.testing.assert_array_equal(np.asarray(vy[s]), np.asarray(ssy[0]))


# ---------------------------------------------------------------------------
# Estimator: unbiased mean, reduced seed-to-seed variance at edges
# ---------------------------------------------------------------------------


def test_mean_agreement_and_variance_reduction():
    # Dim emitter: sample variance stays under the adaptive threshold, so
    # the estimate is exactly the (stratified) base phase — the cleanest
    # A/B of the sampler itself.
    n = 48
    dim = [{"center": [0.0, 0.0, -3.0], "radius": 1.0,
            "color": [0, 0, 0], "emission": [1.0, 1.0, 1.0],
            "reflectivity": 0.0}]
    outs = {}
    for sampler in ("reference", "stratified"):
        tr = PathTracer(_edge_scene(sampler=sampler, spheres=dim))
        if sampler == "stratified":
            assert tr.strat_g == 2
        fn = jax.jit(tr.render_frame)
        frames = np.stack([
            np.asarray(fn(POSE, np.uint32(1000 + 7 * s), np.int32(0))[0].x)
            for s in range(n)
        ])
        outs[sampler] = frames
    m_ref = outs["reference"].mean(axis=0)
    m_st = outs["stratified"].mean(axis=0)
    v_ref = outs["reference"].var(axis=0)
    v_st = outs["stratified"].var(axis=0)
    # Same expectation: the per-pixel means agree within a few combined
    # standard errors (both estimate the identical integral).
    se = np.sqrt((v_ref + v_st) / n) + 1e-6
    assert np.median(np.abs(m_ref - m_st) / se) < 1.0
    assert np.abs(m_ref.mean() - m_st.mean()) < 4 * se.mean() / np.sqrt(
        m_ref.size)
    # Strictly less seed-to-seed variance in aggregate (edges dominate it).
    # Measured baseline on this fixed 48-seed set: ratio ~0.39 (v_st.sum()
    # ~= 0.39 * v_ref.sum()).  The 0.6 margin
    # leaves ~50% headroom for unrelated upstream RNG/numeric drift to
    # read as a margin shift rather than a spurious failure, while still
    # catching a real regression that halves stratification's measured
    # variance reduction.
    assert v_st.sum() < 0.6 * v_ref.sum(), (v_st.sum(), v_ref.sum())


# ---------------------------------------------------------------------------
# Scheduler / backend agreement (the repo's core correctness property)
# ---------------------------------------------------------------------------


def test_pallas_schedulers_match_oracle_stratified():
    scene = _edge_scene(sampler="stratified", samples_per_pixel=32)
    tr = PathTracer(scene)
    assert tr.strat_g == 2
    cur_o, _vo, tot_o, rays_o = _render(tr)
    # Cross-scheduler within the oracle first (regen shares the vector
    # samp carry with the Pallas stream kernel).
    x = jax.lax.broadcasted_iota(jnp.int32, (scene.height, scene.width), 1)
    y = jax.lax.broadcasted_iota(jnp.int32, (scene.height, scene.width), 0)
    from terminal_raytracer.ops import tracer as tracer_mod

    cam = tracer_mod.cam_from_pose(POSE)
    cur_r, _vr, tot_r, rays_r = jax.jit(
        lambda: tr.render_lanes_regen(cam, x, y, np.uint32(42), np.int32(0))
    )()
    np.testing.assert_array_equal(np.asarray(tot_r), np.asarray(tot_o))
    np.testing.assert_allclose(np.asarray(cur_r.x), np.asarray(cur_o.x),
                               atol=2e-6)
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42),
                                         np.int32(0))
    err = "kernel"
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o),
                                  err)
    assert float(rays_p) == float(rays_o), err
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y),
                 (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, err_msg=err)


def test_reference_sampler_unchanged():
    # The default compiles the exact pre-extension program: explicit
    # 'reference' and the field's default render bit-identically.
    a = _render(PathTracer(_edge_scene()))
    b = _render(PathTracer(_edge_scene(sampler="reference")))
    np.testing.assert_array_equal(np.asarray(a[0].x), np.asarray(b[0].x))
    # And stratified really changes the image (the gate is live).
    c = _render(PathTracer(_edge_scene(sampler="stratified")))
    assert not np.array_equal(np.asarray(a[0].x), np.asarray(c[0].x))
