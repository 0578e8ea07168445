"""ANSI blitter: native/Python byte identity, escape-stream snapshot, and
format conformance (SURVEY.md §4.4's "glyph/ANSI snapshot test")."""

import numpy as np
import pytest

from terminal_raytracer.runtime.blit import Blitter


def _frame(h=7, w=13, seed=0):
    r = np.random.RandomState(seed)
    return (
        r.randint(0, 256, (h, w, 3), np.uint8),
        r.randint(0, 68, (h, w), np.uint8),
    )


@pytest.mark.parametrize("full_color", [True, False])
def test_native_matches_python(full_color):
    rgb, gl = _frame()
    native = Blitter(7, 13, full_color)
    python = Blitter(7, 13, full_color, force_python=True)
    assert native.encode(rgb, gl) == python.encode(rgb, gl)


def test_snapshot_exact_bytes():
    """Byte-for-byte cell format (lib.rs:509-524): truecolor prefix, glyph
    or UTF-8 block, reset, CRLF rows."""
    rgb = np.array([[[255, 0, 7], [1, 128, 255]]], np.uint8)
    gl = np.array([[0, 67]], np.uint8)
    fc = Blitter(1, 2, True).encode(rgb, gl)
    assert fc == (
        b"\x1b[38;2;255;0;7m\xe2\x96\x88\x1b[0m"
        b"\x1b[38;2;1;128;255m\xe2\x96\x88\x1b[0m\r\n"
    )
    ascii_ = Blitter(1, 2, False).encode(rgb, gl)
    assert ascii_ == (
        b"\x1b[38;2;255;0;7m \x1b[0m"  # glyph 0 = space
        b"\x1b[38;2;1;128;255m$\x1b[0m\r\n"  # glyph 67 = '$'
    )


def test_glyph_index_clamped():
    rgb = np.zeros((1, 1, 3), np.uint8)
    gl = np.array([[255]], np.uint8)  # out of range -> clamped to '$'
    for force in (False, True):
        out = Blitter(1, 1, False, force_python=force).encode(rgb, gl)
        assert b"$" in out


def test_thread_counts_agree():
    rgb, gl = _frame(h=40, w=100, seed=3)
    ref = Blitter(40, 100, True, threads=1).encode(rgb, gl)
    for t in (2, 4, 16, 64):
        assert Blitter(40, 100, True, threads=t).encode(rgb, gl) == ref


def test_none_glyphs_fullcolor():
    rgb, _ = _frame()
    out = Blitter(7, 13, True).encode(rgb, None)
    assert out.count(b"\xe2\x96\x88") == 7 * 13
