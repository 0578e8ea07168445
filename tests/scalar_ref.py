"""Scalar NumPy reference path tracer — the trusted oracle for the oracle.

An independent, deliberately naive per-pixel implementation of the reference
kernel's semantics (reference: src/shader.wgsl) with *real* divergent
control flow (per-path breaks, data-dependent RNG draws), exactly as a
scalar GPU thread would execute. It is used by the test-suite to validate
the vectorized wavefront tracer statistically: both must converge to the
same per-pixel mean radiance (they draw different RNG sequences, so
agreement is within Monte-Carlo error — "parity modulo RNG", PARITY.md).

Slow by construction; tests use it on a handful of pixels / tiny images.
"""

from __future__ import annotations

import numpy as np

F = np.float32
U = np.uint32


# ---- RNG (shader.wgsl:104-115) ---------------------------------------------


class Rng:
    def __init__(self, state: int):
        self.state = U(state)

    @staticmethod
    def hash(x: U) -> U:
        with np.errstate(over="ignore"):
            state = U(x) * U(747796405) + U(2891336453)
            word = ((state >> ((state >> U(28)) + U(4))) ^ state) * U(277803737)
            return (word >> U(22)) ^ word

    def f32(self) -> F:
        self.state = self.hash(self.state)
        return F(self.state) / F(4294967295.0)


# ---- vec helpers -------------------------------------------------------------


def dot(a, b):
    return float(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def norm(v):
    return v / np.sqrt(dot(v, v))


def cross(a, b):
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        F,
    )


def reflect(v, n):
    return v - n * F(2.0 * dot(v, n))


# ---- intersections (shader.wgsl:155-223) ------------------------------------


def hit_sphere(o, d, center, radius, t_min, t_max):
    oc = center - o
    h = dot(d, oc)
    c = dot(oc, oc) - radius * radius
    disc = h * h - c
    if disc < 0.0:
        return -1.0
    sq = np.sqrt(disc)
    root = h - sq
    if root <= t_min or t_max <= root:
        root = h + sq
        if root <= t_min or t_max <= root:
            return -1.0
    return float(root)


def hit_plane(o, d, point, normal, t_min, t_max):
    denom = dot(normal, d)
    if abs(denom) < 1e-4:
        return -1.0
    t = dot(point - o, normal) / denom
    if t < t_min or t > t_max:
        return -1.0
    return float(t)


def hit_triangle(o, d, v0, v1, v2, t_min, t_max):
    e1 = v1 - v0
    e2 = v2 - v0
    h = cross(d, e2)
    a = dot(e1, h)
    if -1e-5 < a < 1e-5:
        return -1.0
    f = 1.0 / a
    s = o - v0
    u = f * dot(s, h)
    if u < 0.0 or u > 1.0:
        return -1.0
    q = cross(s, e1)
    v = f * dot(d, q)
    if v < 0.0 or u + v > 1.0:
        return -1.0
    t = f * dot(e2, q)
    if t_min < t < t_max:
        return float(t)
    return -1.0


# ---- scene adapters ----------------------------------------------------------


class Prim:
    def __init__(self, kind, mat, **geo):
        self.kind = kind  # 0 sphere, 1 plane, 2 triangle
        self.color = np.array(mat.color, F)
        self.emission = np.array(mat.emission, F)
        self.reflectivity = F(mat.reflectivity)
        self.geo = {k: (np.array(v, F) if hasattr(v, "__len__") else F(v)) for k, v in geo.items()}

    def intersect(self, o, d, t_min, t_max):
        g = self.geo
        if self.kind == 0:
            return hit_sphere(o, d, g["center"], g["radius"], t_min, t_max)
        if self.kind == 1:
            return hit_plane(o, d, g["point"], g["normal"], t_min, t_max)
        return hit_triangle(o, d, g["v0"], g["v1"], g["v2"], t_min, t_max)

    def normal_at(self, p):
        g = self.geo
        if self.kind == 0:
            return norm((p - g["center"]) / g["radius"])
        if self.kind == 1:
            return norm(g["normal"])
        return norm(cross(g["v1"] - g["v0"], g["v2"] - g["v0"]))


def prims_from_scene(scene):
    from terminal_raytracer.models import scene as sm

    out = []
    for tag, p in scene.primitives:
        if tag == sm.SPHERE:
            out.append(Prim(0, p.material, center=p.center, radius=p.radius))
        elif tag == sm.PLANE:
            out.append(Prim(1, p.material, point=p.point, normal=p.normal))
        else:
            out.append(Prim(2, p.material, v0=p.v0, v1=p.v1, v2=p.v2))
    return out


# ---- tracer (shader.wgsl:248-495) --------------------------------------------


def hit_scene(prims, o, d, t_min, t_max):
    closest = t_max
    best = None
    for prim in prims:
        t = prim.intersect(o, d, t_min, closest)
        if t > 0.0 and t < closest:
            closest = t
            best = prim
    if best is None:
        return None
    p = o + d * F(closest)
    n = best.normal_at(p)
    if dot(d, n) >= 0.0:
        n = -n
    return dict(t=closest, p=p, normal=n, prim=best)


def sky(d):
    t = 0.5 * (d[1] + 1.0)
    return (np.array([1.0, 1.0, 1.0], F) * F(1.0 - t) + np.array([0.5, 0.7, 1.0], F) * F(t)) * F(0.8)


def sample_cosine_hemisphere(rng, normal):
    r1, r2 = rng.f32(), rng.f32()
    cos_t = np.sqrt(r1)
    sin_t = np.sqrt(1.0 - r1)
    phi = 2.0 * 3.14159265359 * r2
    x, y, z = sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t
    w = norm(normal)
    if abs(w[0]) > 0.1:
        u = norm(cross(np.array([0.0, 1.0, 0.0], F), w))
    else:
        u = norm(cross(np.array([1.0, 0.0, 0.0], F), w))
    v = cross(w, u)
    return norm(u * F(x) + v * F(y) + w * F(z))


def sample_direct(prims, rng, p, normal, color, att):
    direct = np.zeros(3, F)
    for prim in prims:
        if float(prim.emission.sum()) <= 0.001:
            continue
        if prim.kind == 0:
            r1, r2 = rng.f32(), rng.f32()
            cos_t = 1.0 - 2.0 * r1
            sin_t = np.sqrt(1.0 - cos_t * cos_t)
            phi = 2.0 * 3.14159265359 * r2
            local = np.array([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], F)
            lp = prim.geo["center"] + local * prim.geo["radius"]
            ln = local
            area = 4.0 * 3.14159265359 * float(prim.geo["radius"]) ** 2
        elif prim.kind == 2:
            r1, r2 = rng.f32(), rng.f32()
            sq = np.sqrt(r1)
            u = 1.0 - sq
            v = r2 * sq
            lp = prim.geo["v0"] * F(1.0 - u - v) + prim.geo["v1"] * F(u) + prim.geo["v2"] * F(v)
            e1 = prim.geo["v1"] - prim.geo["v0"]
            e2 = prim.geo["v2"] - prim.geo["v0"]
            cr = cross(e1, e2)
            ln = norm(cr)
            area = 0.5 * float(np.sqrt(dot(cr, cr)))
        else:
            continue
        lvec = lp - p
        ldist = float(np.sqrt(dot(lvec, lvec)))
        ldir = lvec / F(ldist)
        shadow = hit_scene(prims, p + normal * F(0.001), ldir, 0.001, ldist - 0.001)
        if shadow is None:
            cos_s = max(0.0, dot(normal, ldir))
            cos_l = max(0.0, dot(ln, -ldir))
            if cos_s > 0.0 and cos_l > 0.0:
                geom = (cos_s * cos_l) / (ldist * ldist)
                brdf = color / F(3.14159265359)
                contrib = brdf * prim.emission * att * F(geom * area)
                direct += np.minimum(contrib, 10.0)
    return direct


def ray_color(prims, rng, o, d, max_depth):
    acc = np.zeros(3, F)
    att = np.ones(3, F)
    for i in range(max_depth):
        hit = hit_scene(prims, o, d, 0.001, 1e10)
        if hit is None:
            acc += sky(d) * att
            break
        prim = hit["prim"]
        acc += prim.emission * att
        acc += sample_direct(prims, rng, hit["p"], hit["normal"], prim.color, att)
        if prim.reflectivity > rng.f32():
            scatter = reflect(d, hit["normal"])
        else:
            scatter = sample_cosine_hemisphere(rng, hit["normal"])
        att = att * prim.color
        o = hit["p"] + scatter * F(0.001)
        d = scatter
        if i > 3:
            p_surv = min(0.95, float(att.max()))
            if p_surv < rng.f32():
                break
            att = att / F(p_surv)
    return acc


def camera_basis(yaw, pitch):
    """Yaw/pitch fly-camera basis (reference: src/camera.rs:17-26):
    forward = (cos yaw * cos pitch, sin pitch, sin yaw * cos pitch),
    right = (-sin yaw, 0, cos yaw), up = right x forward. f64 trig narrowed
    to f32 components, matching models/camera.py's order so same-seed
    parity at moved poses stays exact."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    forward = np.array([cy * cp, sp, sy * cp], F)
    right = np.array([-sy, 0.0, cy], F)
    up = np.cross(right, forward).astype(F)
    return forward, right, up


def render_pixel(scene, x, y, seed, frame_number, n_samples=None,
                 position=(0.0, 0.0, 0.0), yaw=-np.pi / 2.0, pitch=0.0):
    """Mean radiance of `n_samples` *proper* samples of pixel (x, y) — i.e.
    sum/n, without the reference's adaptive normalization quirks, for
    statistical comparison against the wavefront tracer's raw sample mean.

    position/yaw/pitch: the camera pose (defaults: the reference's initial
    pose — origin, looking down -z, lib.rs:118)."""
    prims = prims_from_scene(scene)
    w, h = scene.width, scene.height
    half_h = np.tan(F(scene.fov_rad) / F(2.0))
    half_w = F(w) / F(h) * half_h
    inv_char = F(1.0) / F(scene.camera.char_aspect_ratio)
    n = n_samples if n_samples is not None else scene.samples_per_pixel
    forward, right, up = camera_basis(yaw, pitch)
    pos = np.asarray(position, F)
    with np.errstate(over="ignore"):
        state = U(U(y * w + x) * U(1973) + U(seed) * U(9277) + U(frame_number) * U(12345))
    rng = Rng(state)
    total = np.zeros(3, np.float64)
    for i in range(n):
        with np.errstate(over="ignore"):
            rng.state = Rng.hash(rng.state + U(i) * U(5096))
        u = (F(x) + rng.f32()) / F(w - 1)
        v = (F(h - 1 - y) + rng.f32()) / F(h - 1)
        ndc_x = 2.0 * u - 1.0
        ndc_y = (2.0 * v - 1.0) * inv_char
        vx, vy = half_w * ndc_x, half_h * ndc_y
        d = norm(right * F(vx) + up * F(vy) + forward)
        o = pos.copy()
        total += ray_color(prims, rng, o, d, scene.max_depth)
    return (total / n).astype(F)
