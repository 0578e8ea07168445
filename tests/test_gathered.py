"""Per-lane gathered grid traversal (ops/gathered.py): walk correctness
against the brute sweeps, extension-channel winner fetches, occlusion,
and full-pipeline oracle/Pallas agreement.

The traversal ships OPT-IN (`--accel gathered`; its status is in the
ops/gathered.py docstring) — the brute sweep stays the auto policy. These
tests keep the opt-in path correct.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models.gen import icosphere_scene, stress_scene
from terminal_raytracer.ops import gathered as gathered_mod
from terminal_raytracer.ops import geometry as geom
from terminal_raytracer.ops.vecmath import V3
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def small_stress(n=48):
    return stress_scene(n, seed=3, width=64, height=16,
                        samples_per_pixel=4, max_depth=2)


def random_rays(n=512, seed=3):
    rng = np.random.RandomState(seed)
    o = V3(jnp.asarray(rng.uniform(-14, 14, n).astype(np.float32)),
           jnp.asarray(rng.uniform(0.2, 8, n).astype(np.float32)),
           jnp.asarray(rng.uniform(-26, 0, n).astype(np.float32)))
    dv = rng.normal(size=(3, n)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=0, keepdims=True)
    return o, V3(*(jnp.asarray(c) for c in dv))


def _assert_hits_match(h1, h2, rtol=1e-4):
    """Same winners and records, allowing the known FMA-contraction ulps
    (t computed from table values vs folded constants — the arrayscene
    caveat) and measure-zero tie reorders (none observed on these seeds)."""
    f1, f2 = np.asarray(h1.found), np.asarray(h2.found)
    np.testing.assert_array_equal(f1, f2)
    m = f1
    np.testing.assert_allclose(np.asarray(h1.t)[m], np.asarray(h2.t)[m],
                               rtol=rtol)
    for name in ("color", "emission"):
        a, b = getattr(h1, name), getattr(h2, name)
        for c in "xyz":
            np.testing.assert_allclose(
                np.asarray(getattr(a, c))[m], np.asarray(getattr(b, c))[m],
                atol=1e-6)
    np.testing.assert_allclose(np.asarray(h1.reflectivity)[m],
                               np.asarray(h2.reflectivity)[m], atol=1e-6)
    np.testing.assert_allclose(np.asarray(h1.light_inv_area)[m],
                               np.asarray(h2.light_inv_area)[m], rtol=1e-5)
    # Sphere normals amplify the t ulps near grazing incidence
    # (|dn| ~ dt/r — observed 1.3e-4 at dt/t ~ 4e-6 on r ~ 0.3 spheres),
    # so their tolerance is looser than the record channels'.
    for c in "xyz":
        np.testing.assert_allclose(
            np.asarray(getattr(h1.normal, c))[m],
            np.asarray(getattr(h2.normal, c))[m], atol=2e-3)


def test_closest_hit_matches_baked():
    scene = small_stress(96)
    gp = gathered_mod.GatheredPrims(scene)
    sp = geom.ScenePrims(scene)
    o, d = random_rays()
    _assert_hits_match(sp.closest_hit(o, d), gp.closest_hit(o, d))


def test_occluded_matches_baked():
    scene = small_stress(96)
    gp = gathered_mod.GatheredPrims(scene)
    sp = geom.ScenePrims(scene)
    o, d = random_rays(seed=11)
    t_max = jnp.asarray(
        np.random.RandomState(4).uniform(1, 30, 512).astype(np.float32))
    b1 = np.asarray(sp.occluded(o, d, geom.RAY_EPS, t_max))
    b2 = np.asarray(gp.occluded(o, d, geom.RAY_EPS, t_max))
    np.testing.assert_array_equal(b1, b2)


def test_triangles_and_mixed():
    """Mixed sphere+triangle walk (the icosphere mesh + its light)."""
    scene = icosphere_scene(1, width=48, height=12, samples_per_pixel=2,
                            max_depth=2)
    gp = gathered_mod.GatheredPrims(scene)
    sp = geom.ScenePrims(scene)
    rng = np.random.RandomState(9)
    n = 512
    o = V3(jnp.asarray(rng.uniform(-4, 4, n).astype(np.float32)),
           jnp.asarray(rng.uniform(0.2, 6, n).astype(np.float32)),
           jnp.asarray(rng.uniform(-10, -2, n).astype(np.float32)))
    dv = rng.normal(size=(3, n)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=0, keepdims=True)
    d = V3(*(jnp.asarray(c) for c in dv))
    _assert_hits_match(sp.closest_hit(o, d), gp.closest_hit(o, d))


def test_extension_channels_via_winner_fetch():
    """Glass/roughness channels ride the post-walk winner gather."""
    scene = small_stress(64)
    spheres = list(scene.spheres)
    spheres[3] = spheres[3]._replace(
        material=spheres[3].material._replace(transparency=0.9, ior=1.5))
    spheres[5] = spheres[5]._replace(
        material=spheres[5].material._replace(reflectivity=1.0,
                                              roughness=0.3))
    scene = dataclasses.replace(scene, spheres=tuple(spheres))
    assert scene.has_dielectrics and scene.has_rough_metals
    gp = gathered_mod.GatheredPrims(scene)
    sp = geom.ScenePrims(scene)
    o, d = random_rays(seed=21)
    h1, h2 = sp.closest_hit(o, d), gp.closest_hit(o, d)
    _assert_hits_match(h1, h2)
    m = np.asarray(h1.found)
    for name in ("transparency", "roughness"):
        np.testing.assert_allclose(np.asarray(getattr(h1, name))[m],
                                   np.asarray(getattr(h2, name))[m],
                                   atol=1e-6)
    # ior is only meaningful where transparency > 0 (Hit docstring: the
    # baked sweep zeros it elsewhere as a grouped-select economy; the
    # tracer re-selects a safe value before dividing) — compare there.
    glass = m & (np.asarray(h1.transparency) > 0)
    np.testing.assert_allclose(np.asarray(h1.ior)[glass],
                               np.asarray(h2.ior)[glass], atol=1e-6)


def test_full_render_matches_array():
    """End-to-end oracle render: gathered vs array traversal — exact ray
    counts, tight radiance agreement (FMA-contraction caveat)."""
    scene = small_stress(48)
    a = make_render_step(scene, backend="jnp", accel="array")(
        init_state(scene), POSE, np.uint32(5), np.int32(0))
    g = make_render_step(scene, backend="jnp", accel="gathered")(
        init_state(scene), POSE, np.uint32(5), np.int32(0))
    assert float(a.rays) == float(g.rays)
    np.testing.assert_allclose(np.asarray(a.state.acc),
                               np.asarray(g.state.acc), atol=2e-4)


@pytest.mark.parametrize("block", [32, 64, 128])
def test_pallas_matches_oracle(block):
    """The kernel runs the walk loop on direct table loads (interpret
    mode) decision-exactly vs the oracle's row-sweep fetches, at every
    block size (the image is no multiple of any, so edge masks run).
    spp=16 (base 4 + adaptive extras) so the extra phase consumes the
    gathered tables too."""
    from terminal_raytracer.ops import pallas_kernel as pk
    from terminal_raytracer.ops import tracer as tracer_mod

    scene = dataclasses.replace(small_stress(48), samples_per_pixel=16)
    tr = tracer_mod.PathTracer(scene, accel="gathered")
    cur_o, var_o, tot_o, rays_o = tr.render_frame(POSE, np.uint32(7),
                                                  np.int32(0))
    # Non-vacuous: some pixel drew adaptive extras beyond the base 4.
    assert float(np.asarray(tot_o).max()) > 4.0
    rf = pk.make_render_frame(scene, block=block, accel="gathered",
                              interpret=True)
    cur, var, tot, rays, occ = rf(POSE, np.uint32(7), np.int32(0))
    assert float(rays) == float(np.asarray(rays_o).sum())
    np.testing.assert_array_equal(np.asarray(tot), np.asarray(tot_o))
    np.testing.assert_allclose(np.asarray(cur.x), np.asarray(cur_o.x),
                               atol=1e-4)


def test_pallas_textured_gathered():
    """Image textures + gathered traversal in ONE kernel: the atlas
    operands and the gathered tables ride together (tex-then-gather
    operand ordering), decision-exact vs the oracle."""
    from terminal_raytracer.ops import pallas_kernel as pk
    from terminal_raytracer.ops import tracer as tracer_mod

    scene = load_scene("textured").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=2)
    assert scene.has_texture
    tr = tracer_mod.PathTracer(scene, accel="gathered")
    cur_o, var_o, tot_o, rays_o = tr.render_frame(POSE, np.uint32(11),
                                                  np.int32(0))
    rf = pk.make_render_frame(scene, accel="gathered", interpret=True)
    cur, var, tot, rays, occ = rf(POSE, np.uint32(11), np.int32(0))
    assert float(rays) == float(np.asarray(rays_o).sum())
    np.testing.assert_array_equal(np.asarray(tot), np.asarray(tot_o))
    np.testing.assert_allclose(np.asarray(cur.x), np.asarray(cur_o.x),
                               atol=1e-4)


def test_walk_trip_bound_is_safe():
    """max_trips bounds any walk: a forced full-diagonal ray terminates
    within it (the oracle while_loop would silently truncate otherwise)."""
    scene = small_stress(96)
    gp = gathered_mod.GatheredPrims(scene)
    o = V3(*(jnp.full((8,), v, jnp.float32)
             for v in (-13.9, 0.3, -25.9)))
    d = V3(*(jnp.full((8,), v, jnp.float32)
             for v in (0.55, 0.2, 0.81)))
    st = gp.walk_start(o, d, None, jnp.full((8,), geom.T_FAR, jnp.float32))
    import jax

    def cond(c):
        it, st = c
        return (it < 10 * gp.max_trips) & jnp.any(st.active != 0.0)

    def body(c):
        it, st = c
        return it + 1, gp.walk_step(o, d, geom.RAY_EPS, st)

    it, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
    assert int(it) <= gp.max_trips


def test_dynamic_rejected():
    from terminal_raytracer.ops import tracer as tracer_mod

    with pytest.raises(ValueError, match="gathered"):
        tracer_mod.PathTracer(small_stress(48), accel="gathered",
                              dynamic=True)


def test_needs_primitives():
    scene = load_scene("scene2")
    empty = dataclasses.replace(scene, spheres=(), triangles=())
    with pytest.raises(ValueError, match="spheres/triangles"):
        gathered_mod.GatheredPrims(empty)
