"""The à-trous reconstruction filter (ops/denoise.py) — a capability
extension (the reference's only noise control is more samples,
shader.wgsl:499-602): numpy-reference pin of one pass, static-identity
gate, MSE improvement on a noisy render, convergence fade-out,
chunk-path equality, sharded halo/gather paths, and the CLI flag."""

import jax
import jax.numpy as jnp
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.ops import denoise as dn
from terminal_raytracer.ops.vecmath import V3
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def _np_atrous(color, var, stride, k):
    """Independent numpy reference of one à-trous round (edge-replicate
    shifts, B3 taps, variance-guided edge stop, SVGF var propagation)."""
    taps = np.array([1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16])
    h, w = var.shape
    yy, xx = np.mgrid[0:h, 0:w]
    wsum = np.zeros((h, w))
    csum = np.zeros((3, h, w))
    vsum = np.zeros((h, w))
    for iy in range(5):
        for ix in range(5):
            sy = np.clip(yy - (iy - 2) * stride, 0, h - 1)
            sx = np.clip(xx - (ix - 2) * stride, 0, w - 1)
            cq = color[:, sy, sx]
            vq = var[sy, sx]
            d2 = ((color - cq) ** 2).sum(axis=0)
            wt = taps[iy] * taps[ix] * np.exp(
                -d2 / (k * k * (var + vq + 1e-4)))
            wsum += wt
            csum += cq * wt
            vsum += wt * wt * vq
    inv = 1.0 / np.maximum(wsum, 1e-12)
    return csum * inv, vsum * inv * inv


def test_atrous_pass_matches_numpy():
    rng = np.random.RandomState(7)
    c = rng.rand(3, 12, 17).astype(np.float32) * 2.0
    v = (rng.rand(12, 17).astype(np.float32)) ** 2
    for stride in (1, 2, 4):
        got_c, got_v = dn.atrous_pass(
            V3(jnp.asarray(c[0]), jnp.asarray(c[1]), jnp.asarray(c[2])),
            jnp.asarray(v), stride, 0.8)
        ref_c, ref_v = _np_atrous(c.astype(np.float64),
                                  v.astype(np.float64), stride, 0.8)
        got = np.stack([np.asarray(got_c.x), np.asarray(got_c.y),
                        np.asarray(got_c.z)])
        np.testing.assert_allclose(got, ref_c, rtol=2e-5, atol=2e-6,
                                   err_msg=f"stride={stride}")
        np.testing.assert_allclose(np.asarray(got_v), ref_v,
                                   rtol=2e-5, atol=2e-7)


def _scene(**kw):
    d = dict(width=48, height=24, samples_per_pixel=4, max_depth=3)
    d.update(kw)
    return load_scene("scene2").with_overrides(**d)


def _run(scene, frames, seed0=500, **step_kw):
    step = make_render_step(scene, backend="jnp", **step_kw)
    state = init_state(scene)
    for f in range(frames):
        out = step(state, POSE, np.uint32(seed0 + f), np.int32(f))
        state = out.state
    return out


def test_denoise_zero_is_bit_identity():
    """--denoise 0 (the default) compiles the exact unfiltered program —
    the static extension gate every channel honors (CLAUDE.md)."""
    scene = _scene()
    a = _run(scene, 2)
    b = _run(scene, 2, denoise=0.0, denoise_passes=3)
    np.testing.assert_array_equal(np.asarray(a.rgb), np.asarray(b.rgb))
    np.testing.assert_array_equal(np.asarray(a.state.acc),
                                  np.asarray(b.state.acc))


def test_denoise_reduces_noise_keeps_state_raw():
    """One noisy frame, filtered, must be closer to the converged render
    than the raw frame is — and the checkpointed accumulation must stay
    untouched by the filter (pure display post-process)."""
    scene = _scene()
    ref = _run(scene, 24)  # converged-ish ground truth
    raw = _run(scene, 1)
    fil = _run(scene, 1, denoise=1.0)
    np.testing.assert_array_equal(np.asarray(raw.state.acc),
                                  np.asarray(fil.state.acc))
    truth = np.asarray(ref.state.acc).astype(np.float64)
    # Compare in accumulation space via the u8 rgb the user sees.
    t_rgb = np.asarray(ref.rgb).astype(np.float64)
    mse_raw = ((np.asarray(raw.rgb) - t_rgb) ** 2).mean()
    mse_fil = ((np.asarray(fil.rgb) - t_rgb) ** 2).mean()
    assert mse_fil < 0.8 * mse_raw, (mse_fil, mse_raw)
    assert truth.shape == (3, 24, 48)


def test_denoise_fades_with_convergence():
    """Variance-of-the-mean guidance: as accumulation converges the
    edge-stop tightens and the filter approaches the identity — the
    filtered render converges to the UNFILTERED ground truth."""
    scene = _scene()
    diffs = []
    for frames in (1, 32):
        raw = _run(scene, frames)
        fil = _run(scene, frames, denoise=1.0)
        diffs.append(np.abs(np.asarray(fil.rgb).astype(np.int32)
                            - np.asarray(raw.rgb).astype(np.int32)).mean())
    assert diffs[1] < 0.35 * diffs[0], diffs


def test_denoise_chunk_renderer_matches_per_frame():
    """The chunked headless path finalizes with the same filter at the
    same frame number — bit-identical to per-frame driving."""
    from terminal_raytracer.runtime.offline import make_chunk_renderer

    scene = _scene()
    seeds = np.arange(100, 104, dtype=np.uint32)
    per = make_render_step(scene, backend="jnp", denoise=1.0)
    state = init_state(scene)
    for f, s in enumerate(seeds):
        out = per(state, POSE, np.uint32(s), np.int32(f))
        state = out.state
    chunk = make_chunk_renderer(scene, len(seeds), backend="jnp",
                                denoise=1.0)
    cout, _rays = chunk(init_state(scene), POSE, jnp.asarray(seeds))
    np.testing.assert_array_equal(np.asarray(cout.rgb), np.asarray(out.rgb))


def test_denoise_sharded_halo_matches_single_chip():
    """px sharding with per-pass ppermute halo exchange: bit-identical to
    the single-chip filter (rows=16 >= widest halo 8 -> the halo path)."""
    from terminal_raytracer.parallel import (make_mesh,
                                                 make_sharded_render_step)

    scene = _scene(height=32, width=64)
    mesh = make_mesh(n_px=2, n_sp=1)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp",
                                              denoise=1.0)
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))
    ref = make_render_step(scene, backend="jnp", denoise=1.0)(
        init_state(scene), POSE, np.uint32(5), np.int32(0))
    np.testing.assert_array_equal(np.asarray(out.rgb), np.asarray(ref.rgb))


def test_denoise_sharded_gather_fallback_matches_single_chip():
    """Tiny row blocks (rows=4 < halo 8): the all_gather fallback — same
    bit-identical contract."""
    from terminal_raytracer.parallel import (make_mesh,
                                                 make_sharded_render_step)

    scene = _scene(height=32, width=64)
    mesh = make_mesh(n_px=8, n_sp=1)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp",
                                              denoise=1.0)
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))
    ref = make_render_step(scene, backend="jnp", denoise=1.0)(
        init_state(scene), POSE, np.uint32(5), np.int32(0))
    np.testing.assert_array_equal(np.asarray(out.rgb), np.asarray(ref.rgb))


def test_denoise_cli_headless():
    """In-process CLI run; --no-compile-cache switches JAX's persistent
    cache off (restored afterwards for the rest of this process)."""
    import jax

    from terminal_raytracer.cli import main

    was = jax.config.jax_enable_compilation_cache
    try:
        rc = main(["--scene", "scene2", "--frames", "2", "--denoise", "1.0",
                   "--width", "48", "--height", "24", "--spp", "4",
                   "--depth", "3", "--backend", "jnp", "--no-compile-cache"])
        assert rc == 0
        assert jax.config.jax_enable_compilation_cache is False
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
