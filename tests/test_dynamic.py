"""Dynamic (animated) scenes: array-driven traversal (ops/dynamic.py).

The core contract: with the SAME values, the dynamic path is bit-identical
to the baked path (same intersections, same overwrite-chain winners, same
RNG chains, same adaptive budgets); with CHANGED values, one compiled step
produces the new image without retracing.
"""

import jax
import jax.numpy as jnp
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models.animate import ANIMATORS
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.dynamic import pack_scene
from terminal_raytracer.ops.tracer import PathTracer
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def _scene(name="scene2", **kw):
    over = dict(width=48, height=16, samples_per_pixel=4, max_depth=4)
    over.update(kw)
    return load_scene(name).with_overrides(**over)


def test_dynamic_oracle_bit_identical_to_baked():
    for name in ("scene2", "Cornell_Box"):
        scene = _scene(name)
        cb, vb, tb, rb = jax.jit(PathTracer(scene).render_frame)(
            POSE, np.uint32(9), np.int32(0)
        )
        dyn = PathTracer(scene, dynamic=True)
        cd, vd, td, rd = jax.jit(dyn.render_frame_dynamic)(
            POSE, np.uint32(9), np.int32(0), pack_scene(scene)
        )
        assert float(rb) == float(rd), name
        np.testing.assert_array_equal(np.asarray(tb), np.asarray(td), name)
        np.testing.assert_array_equal(np.asarray(cb.x), np.asarray(cd.x),
                                      name)
        np.testing.assert_array_equal(np.asarray(cb.z), np.asarray(cd.z),
                                      name)


def test_dynamic_no_retrace_on_geometry_change():
    scene = _scene()
    dyn = PathTracer(scene, dynamic=True)
    f = jax.jit(dyn.render_frame_dynamic)
    arrays = pack_scene(scene)
    c1, *_ = f(POSE, np.uint32(9), np.int32(0), arrays)
    moved = dict(arrays)
    moved["s_cx"] = arrays["s_cx"] + np.float32(0.5)
    c2, *_ = f(POSE, np.uint32(9), np.int32(0), moved)
    assert f._cache_size() == 1  # same compilation served both
    assert bool(jnp.any(c2.x != c1.x))


def test_dynamic_pallas_matches_oracle():
    scene = _scene("Cornell_Box", width=140, height=10, max_depth=3)
    arrays = pack_scene(scene)
    dyn = PathTracer(scene, dynamic=True)
    co, _vo, to, ro = jax.jit(dyn.render_frame_dynamic)(
        POSE, np.uint32(3), np.int32(0), arrays
    )
    # The kernel under dynamic values (the value arrays ride as inputs).
    pf = jax.jit(
        pallas_kernel.make_render_frame(scene, interpret=True, dynamic=True)
    )
    cp, _vp, tp, rp, _occ = pf(POSE, np.uint32(3), np.int32(0), arrays)
    assert float(rp) == float(ro)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(to))
    np.testing.assert_allclose(
        np.asarray(cp.x), np.asarray(co.x), atol=2e-5, err_msg="kernel"
    )


def test_dynamic_mis_transport():
    # transports compose with the dynamic path (same reweighting math).
    scene = _scene()
    arrays = pack_scene(scene)
    outs = {}
    for transport in ("reference", "mis"):
        dyn = PathTracer(scene, dynamic=True, transport=transport)
        c, _v, _t, r = jax.jit(dyn.render_frame_dynamic)(
            POSE, np.uint32(9), np.int32(0), arrays
        )
        outs[transport] = (np.asarray(c.x), float(r))
    assert outs["reference"][1] == outs["mis"][1]  # same paths
    assert not np.array_equal(outs["reference"][0], outs["mis"][0])


def test_animated_subset_folding_bit_identical_to_baked():
    """With an `animated` key subset, the non-animated values fold back to
    baked constants — at template values the result must stay bit-identical
    to the fully-baked tracer, for the oracle AND the sorted Pallas
    pipeline."""
    from terminal_raytracer.models.animate import ANIMATOR_KEYS

    scene = _scene("Cornell_Box")
    arrays = pack_scene(scene)
    cb, _vb, tb, rb = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(21), np.int32(0)
    )
    for name, keys in ANIMATOR_KEYS.items():
        dyn = PathTracer(scene, dynamic=True, dyn_animated=keys)
        cd, _vd, td, rd = jax.jit(dyn.render_frame_dynamic)(
            POSE, np.uint32(21), np.int32(0), arrays
        )
        assert float(rb) == float(rd), name
        np.testing.assert_array_equal(np.asarray(tb), np.asarray(td), name)
        np.testing.assert_array_equal(np.asarray(cb.x), np.asarray(cd.x),
                                      name)
    pf = jax.jit(pallas_kernel.make_render_frame(
        scene, interpret=True, dynamic=True,
        animated=ANIMATOR_KEYS["orbit"],
    ))
    cp, _vp, tp, rp, _occ = pf(POSE, np.uint32(21), np.int32(0), arrays)
    assert float(rp) == float(rb)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(tb))
    np.testing.assert_allclose(np.asarray(cp.x), np.asarray(cb.x), atol=2e-5)


def test_animator_keys_declarations_accurate():
    """ANIMATOR_KEYS must cover exactly what each animator varies — the
    folding machinery bakes everything else, so an undeclared moving key
    would silently freeze."""
    from terminal_raytracer.models.animate import ANIMATOR_KEYS

    scene = _scene("Cornell_Box")
    a0 = pack_scene(scene)
    for name, fn in ANIMATORS.items():
        keys = ANIMATOR_KEYS[name]
        touched = set()
        for t in (0, 3, 11, 40):
            at = fn(a0, t)
            for k in a0:
                if not np.array_equal(at[k], a0[k]):
                    touched.add(k)
        undeclared = touched - set(keys)
        assert not undeclared, (name, undeclared)
        # and the declared set is live on this scene (where counts > 0)
        live = {k for k in keys if a0[k].size > 0}
        assert touched & live, name


def test_animators_shapes_and_motion():
    scene = _scene()
    a0 = pack_scene(scene)
    for name, fn in ANIMATORS.items():
        a1 = fn(a0, 0)
        a2 = fn(a0, 7)
        assert set(a1) == set(a0), name
        for k in a0:
            assert a1[k].shape == a0[k].shape, (name, k)
            assert a1[k].dtype == np.float32, (name, k)
        assert any(
            not np.array_equal(a2[k], a1[k]) for k in a0
        ), f"{name} static between t=0 and t=7"
    # orbit preserves pairwise distances among sphere centers
    orb = ANIMATORS["orbit"](a0, 5)
    p0 = np.stack([a0["s_cx"], a0["s_cy"], a0["s_cz"]], -1)
    p1 = np.stack([orb["s_cx"], orb["s_cy"], orb["s_cz"]], -1)
    d0 = np.linalg.norm(p0[:, None] - p0[None], axis=-1)
    d1 = np.linalg.norm(p1[:, None] - p1[None], axis=-1)
    np.testing.assert_allclose(d0, d1, atol=1e-5)


def test_animated_engine_step_sequence():
    """The make_render_step(dynamic=True) surface: frames advance the
    animation, every frame renders fresh (alpha=1), one compilation."""
    scene = _scene()
    step = jax.jit(
        make_render_step(scene, backend="jnp", jit=False, dynamic=True),
        donate_argnums=(0,),
    )
    a0 = pack_scene(scene)
    state = init_state(scene)
    imgs = []
    for t in range(3):
        arrays = ANIMATORS["bob"](a0, t * 4)
        out = step(state, POSE, np.uint32(11), np.int32(0), arrays)
        state = out.state
        imgs.append(np.asarray(out.rgb))
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])


def test_animation_scan_matches_per_frame():
    """The animation-scan program (geometry as scanned inputs) is
    bit-identical to driving the dynamic step frame by frame."""
    from terminal_raytracer.runtime.offline import (
        make_animation_scan_renderer,
    )

    scene = _scene()
    a0 = pack_scene(scene)
    n = 3
    frames = [ANIMATORS["orbit"](a0, t * 3) for t in range(n)]
    arrays_seq = {k: np.stack([f[k] for f in frames]) for k in a0}
    seeds = np.array([11, 222, 3333], np.uint32)

    render = make_animation_scan_renderer(scene, n, backend="jnp")
    rgbs, _g, rays = render(POSE, arrays_seq, seeds)

    step = make_render_step(scene, backend="jnp", jit=True, dynamic=True)
    total = 0.0
    for t in range(n):
        out = step(init_state(scene), POSE, seeds[t], np.int32(0), frames[t])
        np.testing.assert_array_equal(
            np.asarray(rgbs)[t], np.asarray(out.rgb), f"frame {t}"
        )
        total += float(out.rays)
    assert float(rays) == total


def test_animation_scan_honors_transport():
    """--animate --scan --mis must not silently fall back to the reference
    transport (regression: transport was accepted but unforwarded)."""
    from terminal_raytracer.runtime.offline import (
        make_animation_scan_renderer,
    )

    scene = _scene()
    a0 = pack_scene(scene)
    arrays_seq = {k: np.stack([a0[k], a0[k]]) for k in a0}
    seeds = np.array([5, 6], np.uint32)
    out = {}
    for t in (None, "mis"):
        render = make_animation_scan_renderer(scene, 2, backend="jnp",
                                              transport=t)
        rgbs, _g, rays = render(POSE, arrays_seq, seeds)
        out[t] = (np.asarray(rgbs), float(rays))
    assert out[None][1] == out["mis"][1]  # same paths/RNG
    assert not np.array_equal(out[None][0], out["mis"][0])
