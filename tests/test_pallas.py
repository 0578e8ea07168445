"""The GPU megakernel (ops/pallas_kernel.py) on the CPU.

Here the kernel runs in the Pallas interpreter (explicit interpret=True)
against the jnp oracle. Both run the same tracer core with identical gated
RNG chains, so every decision output (ray counts, per-pixel sample totals)
is bit-equal and radiance differs only by float association. What the
interpreter cannot show -- what the GPU's compiler accepts -- is covered by
cross-lowering the kernel for CUDA on the CPU (test_kernel_lowers_for_cuda);
the card itself is exercised by chip_smoke.py and the `gpu`-marked tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer, cam_from_pose
from terminal_raytracer.runtime import init_state, make_render_step
from terminal_raytracer.runtime.state import resolve_backend

POSE = Camera().pose()


def _compare(scene, seed=42, frame=0, block=None):
    of = jax.jit(PathTracer(scene).render_frame)
    cur_o, var_o, tot_o, rays_o = of(POSE, np.uint32(seed), np.int32(frame))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, block=block,
                                                 interpret=True))
    cur_p, var_p, tot_p, rays_p, _occ = pf(POSE, np.uint32(seed),
                                           np.int32(frame))
    for p, o in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y), (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(np.asarray(p), np.asarray(o), atol=2e-5)
    np.testing.assert_allclose(np.asarray(var_p), np.asarray(var_o),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o))
    assert float(rays_p) == float(rays_o)


def test_exact_tile_shape():
    # 8x128 == exactly eight 128-lane blocks
    scene = load_scene("scene2").with_overrides(
        width=128, height=8, samples_per_pixel=4, max_depth=3
    )
    _compare(scene)


def test_partial_edge_tiles():
    # 140x10: the last block runs past the image; its lanes must not
    # contribute (wrong ray counts / NaNs would surface here).
    scene = load_scene("scene2").with_overrides(
        width=140, height=10, samples_per_pixel=4, max_depth=3
    )
    _compare(scene)


@pytest.mark.parametrize("block", [32, 64, 256])
def test_block_edge_masking(block):
    """Widths that are no multiple of the block: rows straddle blocks and
    the last block is partly ballast; masked stores keep every output
    exact at every block size."""
    scene = load_scene("scene2").with_overrides(
        width=37, height=5, samples_per_pixel=4, max_depth=3
    )
    _compare(scene, block=block)


def test_adaptive_sampling_path():
    # spp 16 > base 4: exercises the per-lane extra-sample quota vs the
    # oracle's lockstep while-mode loop — identical decisions.
    scene = load_scene("Cornell_Box").with_overrides(
        width=128, height=8, samples_per_pixel=16, max_depth=2
    )
    _compare(scene)


def test_deep_bounces_russian_roulette():
    scene = load_scene("demo").with_overrides(
        width=128, height=8, samples_per_pixel=4, max_depth=12
    )
    _compare(scene)


def test_rays_counted_only_for_real_pixels():
    # Width 129 leaves a 127-lane ballast tail in the last block; ray
    # totals must match the oracle exactly (which has no ballast at all).
    scene = load_scene("scene2").with_overrides(
        width=129, height=8, samples_per_pixel=4, max_depth=3
    )
    _compare(scene)


def test_row_offset_renders_a_row_block():
    """shard_rows + runtime y0: the kernel renders rows [y0, y0+rows) of
    the global image with global pixel seeds and camera rays."""
    scene = load_scene("scene2").with_overrides(
        width=40, height=8, samples_per_pixel=4, max_depth=3
    )
    full = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))(
        POSE, np.uint32(3), np.int32(0))
    part = jax.jit(pallas_kernel.make_render_frame(
        scene, shard_rows=3, interpret=True))(
        POSE, np.uint32(3), np.int32(0), y0=4)
    np.testing.assert_array_equal(np.asarray(part[0].x),
                                  np.asarray(full[0].x)[4:7])
    np.testing.assert_array_equal(np.asarray(part[2]),
                                  np.asarray(full[2])[4:7])


def test_occupancy_metric():
    """The kernel surfaces measured sweep-weighted lane occupancy — owed
    sweeps over executed lane-iteration sweeps — through the render step;
    its ray count (the numerator) equals the oracle's. The jnp oracle
    surfaces a real fraction too."""
    scene = load_scene("scene2").with_overrides(
        width=128, height=16, samples_per_pixel=8, max_depth=3
    )
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    _c, _v, _t, rays, occ = jax.device_get(
        pf(POSE, np.uint32(5), np.int32(0)))
    assert 0.0 < float(occ) <= 1.0
    of = jax.jit(PathTracer(scene).render_frame)
    assert float(rays) == float(of(POSE, np.uint32(5), np.int32(0))[3])

    step = make_render_step(scene, backend="pallas", interpret=True)
    out = step(init_state(scene), POSE, np.uint32(5), np.int32(0))
    assert float(jax.device_get(out.occupancy)) == pytest.approx(float(occ))
    step_j = make_render_step(scene, backend="jnp")
    out_j = step_j(init_state(scene), POSE, np.uint32(5), np.int32(0))
    occ_j = float(jax.device_get(out_j.occupancy))
    assert 0.0 < occ_j <= 1.0, occ_j


def test_regen_scheduler_decisions_match_lockstep():
    """render_lanes_regen (the kernel body) vs render_lanes (the oracle's
    lockstep schedule) in plain jnp: the same gated RNG draws, so sample
    totals and per-pixel ray counts are bit-equal."""
    scene = load_scene("Cornell_Box").with_overrides(
        width=48, height=6, samples_per_pixel=16, max_depth=6
    )
    tr = PathTracer(scene)
    y = jax.lax.broadcasted_iota(jnp.int32, (6, 48), 0)
    x = jax.lax.broadcasted_iota(jnp.int32, (6, 48), 1)
    cam = cam_from_pose(POSE)
    lock = jax.jit(lambda: tr.render_lanes(cam, x, y, np.uint32(8),
                                           np.int32(0)))()
    regen = jax.jit(lambda: tr.render_lanes_regen(cam, x, y, np.uint32(8),
                                                  np.int32(0)))()
    np.testing.assert_array_equal(np.asarray(lock[2]), np.asarray(regen[2]))
    np.testing.assert_array_equal(np.asarray(lock[3]), np.asarray(regen[3]))
    np.testing.assert_allclose(np.asarray(lock[0].x), np.asarray(regen[0].x),
                               atol=2e-5)


def test_interpret_must_be_explicit():
    """Off a GPU the kernel is refused unless interpret=True is passed —
    no silent interpreter fallback hides the device."""
    scene = load_scene("scene2").with_overrides(width=16, height=4)
    with pytest.raises(ValueError, match="interpret=True"):
        pallas_kernel.make_render_frame(scene)
    with pytest.raises(ValueError, match="only for a GPU"):
        make_render_step(scene, backend="pallas")
    pallas_kernel.make_render_frame(scene, interpret=True)


def test_block_must_be_power_of_two():
    scene = load_scene("scene2").with_overrides(width=16, height=4)
    for bad in (16, 96):
        with pytest.raises(ValueError, match="power of two"):
            pallas_kernel.make_render_frame(scene, block=bad, interpret=True)


def test_auto_backend_resolution():
    """'auto' is the kernel on a GPU and the jnp oracle anywhere else;
    explicit choices pass through; the step records what it runs."""
    assert resolve_backend("auto", platform="gpu") == "pallas"
    assert resolve_backend("auto", platform="cpu") == "jnp"
    assert resolve_backend("jnp", platform="gpu") == "jnp"
    assert resolve_backend("pallas", platform="cpu") == "pallas"
    scene = load_scene("scene2").with_overrides(width=16, height=4)
    assert make_render_step(scene).backend == "jnp"  # this CPU run
    assert make_render_step(scene, backend="pallas",
                            interpret=True).backend == "pallas"


@pytest.mark.parametrize("name,kw", [
    ("Cornell_Box", {}),
    ("stress:1024", {}),
    ("demo", {"dynamic": True}),
    ("textured", {}),
])
def test_kernel_lowers_for_cuda(name, kw, monkeypatch):
    """The kernel lowers to Triton IR for CUDA at full width — the
    shipped scene, the array-resident traversal, a dynamic scene, and
    direct texture loads — checked on the CPU by exporting for the 'cuda'
    platform (the Triton lowering runs in Python; only the final PTX
    compile needs the card)."""
    from jax.export import DisabledSafetyCheck, export

    monkeypatch.setattr(pallas_kernel, "require_device", lambda *a: None)
    scene = load_scene(name)
    rf = pallas_kernel.make_render_frame(scene, **kw)
    args = (POSE, np.uint32(1), np.int32(0))
    if kw.get("dynamic"):
        from terminal_raytracer.ops.dynamic import pack_scene

        args += ({k: jnp.asarray(v) for k, v in pack_scene(scene).items()},)
    exp = export(jax.jit(rf), platforms=["cuda"], disabled_checks=[
        DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(*args)
    assert "regen_megakernel" in exp.mlir_module()
