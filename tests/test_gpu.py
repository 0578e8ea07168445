"""Card-only checks (marker `gpu`): the compiled kernel against the jnp
path on the card, and the card against the host CPU, within the stated
tolerances of runtime/compare.py. They skip on the CPU; on the card run
`python -m pytest tests/ -m gpu -s` (chip_smoke.py does). Each check
prints its readings, the basis of the limits."""

import jax
import pytest

from terminal_raytracer.models import load_scene
from terminal_raytracer.runtime import compare as cmp

pytestmark = pytest.mark.gpu


def _cornell(**kw):
    return load_scene("Cornell_Box").with_overrides(**kw)


def _check(label, a, b, tol):
    res = cmp.compare(a, b, tol)
    print(f"[{label}] budgets differ on {res['budget_mismatch_share']:.3e} "
          f"of px, rays_rel={res['rays_rel']:.3e}, "
          f"mean_rel={res['mean_rel']:.3e}")
    assert res["ok"], res


def test_kernel_matches_jnp_on_card(gpu):
    """North-star size: decisions agree on all but a stated share of
    pixels, the image mean within its tolerance."""
    scene = _cornell(samples_per_pixel=16, max_depth=32)
    _check("kernel_vs_jnp", cmp.render_once(scene, "pallas"),
           cmp.render_once(scene, "jnp"), cmp.KERNEL_VS_JNP)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_card_matches_cpu(gpu, backend):
    scene = _cornell(width=128, height=64, samples_per_pixel=16, max_depth=8)
    ref = cmp.render_once(scene, "jnp", device=jax.devices("cpu")[0])
    _check(f"{backend}_gpu_vs_cpu", cmp.render_once(scene, backend), ref,
           cmp.CARD_VS_CPU)


@pytest.mark.parametrize("name,accel", [
    ("stress:64", "grid"), ("stress:64", "gathered"),
    ("bumpy", "auto"), ("envmap", "auto"),
])
def test_kernel_compiles_and_agrees(gpu, name, accel):
    """The opt-in traversals and the atlas readers (texture + normal map;
    sky) compile for the card and agree with the jnp path there (the
    array traversal and dynamic values run in chip_smoke.py's cells)."""
    import numpy as np

    from terminal_raytracer.models import Camera
    from terminal_raytracer.ops import pallas_kernel
    from terminal_raytracer.ops.tracer import PathTracer

    scene = load_scene(name).with_overrides(width=200, height=100,
                                            samples_per_pixel=8, max_depth=6)
    args = (Camera().pose(), np.uint32(3), np.int32(0))
    k = jax.device_get(jax.jit(pallas_kernel.make_render_frame(
        scene, accel=accel))(*args))
    o = jax.device_get(jax.jit(PathTracer(scene, accel=accel).render_frame)(
        *args))
    to_res = lambda r: (np.stack([r[0].x, r[0].y, r[0].z]),  # noqa: E731
                        np.asarray(r[2]), float(r[3]))
    _check(f"{name}-{accel}", to_res(k), to_res(o), cmp.FEATURE_SCENES)
