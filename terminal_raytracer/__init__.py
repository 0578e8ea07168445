"""terminal_raytracer — a JAX/XLA/Pallas terminal path tracer for NVIDIA GPUs.

A brand-new framework with the capabilities of the Rust+wgpu reference
(Gooey321/Terminal-Raytracer): physically-based path tracing of spheres /
infinite planes / triangles with diffuse+mirror materials, next-event
estimation, cosine-weighted hemisphere sampling, Russian-roulette
termination, per-pixel adaptive sampling, and temporal accumulation —
rendered straight into the terminal as ASCII glyphs or 24-bit truecolor
block cells, with interactive WASD/arrow camera controls.

Layer map (after SURVEY.md §1's layer mapping):

  models/    scene JSON schema -> SoA arrays + static primitive tuples; fly camera
  ops/       the compute path: SoA vec3 math, PCG RNG, intersections, sampling,
             the wavefront path-trace core (pure jax.numpy oracle) and the
             GPU megakernel (Pallas, Triton route); on-device tonemap
  parallel/  jax.sharding Mesh / shard_map multi-card scale-out
  runtime/   jit-stable render step + frame state, terminal frontend,
             native ANSI blitter bindings, phase timers
  utils/     image/state IO

Everything on the hot path is either XLA-compiled jax.numpy, the Pallas
GPU kernel, or C++ (the terminal ANSI encoder).
"""

__version__ = "0.1.0"
