"""Fly-camera math vs reference camera.rs:17-26 and input handling
lib.rs:393-405."""

import numpy as np

from terminal_raytracer.models.camera import Camera, PITCH_CLAMP


def test_default_pose_looks_down_negative_z():
    cam = Camera()
    f, r, u = cam.basis()
    np.testing.assert_allclose(f, [0, 0, -1], atol=1e-7)
    np.testing.assert_allclose(r, [1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(u, [0, 1, 0], atol=1e-7)


def test_basis_formula_matches_reference():
    cam = Camera(yaw=0.7, pitch=-0.3)
    f, r, u = cam.basis()
    np.testing.assert_allclose(
        f,
        [np.cos(0.7) * np.cos(-0.3), np.sin(-0.3), np.sin(0.7) * np.cos(-0.3)],
        rtol=1e-6,
    )
    np.testing.assert_allclose(r, [-np.sin(0.7), 0.0, np.cos(0.7)], rtol=1e-6)
    np.testing.assert_allclose(u, np.cross(r, f), rtol=1e-6)


def test_basis_orthonormal():
    for yaw, pitch in [(0.0, 0.0), (1.2, 0.9), (-2.1, -1.4)]:
        f, r, u = Camera(yaw=yaw, pitch=pitch).basis()
        assert abs(np.dot(f, r)) < 1e-6
        assert abs(np.dot(f, u)) < 1e-6
        assert abs(np.dot(r, u)) < 1e-6
        np.testing.assert_allclose(np.linalg.norm(f), 1.0, rtol=1e-6)


def test_wasd_moves():
    cam = Camera()
    assert cam.apply_key("w")
    np.testing.assert_allclose(cam.position, [0, 0, -0.1], atol=1e-7)
    cam2 = Camera()
    assert cam2.apply_key("d")
    np.testing.assert_allclose(cam2.position, [0.1, 0, 0], atol=1e-7)
    assert not Camera().apply_key("x")  # unknown key: no movement


def test_arrow_turns_and_pitch_clamp():
    cam = Camera()
    assert cam.apply_key("left")
    assert cam.yaw == -np.pi / 2 - 0.05
    for _ in range(100):
        cam.apply_key("up")
    assert cam.pitch == PITCH_CLAMP


def test_pose_layout():
    cam = Camera(yaw=0.3, pitch=0.1)
    cam.position = np.array([1.0, 2.0, 3.0], np.float32)
    p = cam.pose()
    assert p.shape == (16,) and p.dtype == np.float32
    f, r, u = cam.basis()
    np.testing.assert_allclose(p[0:3], [1, 2, 3])
    np.testing.assert_allclose(p[3:6], f)
    np.testing.assert_allclose(p[6:9], r)
    np.testing.assert_allclose(p[9:12], u)
