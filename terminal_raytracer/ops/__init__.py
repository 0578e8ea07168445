"""Compute path: SoA vec math, PCG RNG, intersections, samplers, the
wavefront path-trace core (jnp oracle + the GPU megakernel), tonemap."""

from . import geometry, rng, sampling, tonemap, tracer, vecmath  # noqa: F401
