"""Pixel-level oracle parity (VERDICT r1 item 6).

The committed NumPy oracle (esctp1raytracer_tpu/testing/oracle.py) is an
independent scalar-per-pixel implementation of the reference algorithm
with the framework's deterministic sampling. Because light draws are
identical, agreement is pixel-level: >= 99% of pixels within 1e-3, and
the remainder only at eps-window/silhouette boundaries.
"""

import os

import numpy as np
import pytest

from esctp1raytracer_tpu import Camera, RenderConfig, cornell_box, render
from esctp1raytracer_tpu.scene.builders import sphere_plane_scene
from esctp1raytracer_tpu.testing import oracle_render


def _compare(scene, lookfrom, lookat, w, h, backend, vfov=60.0):
    cam = Camera.look_at(lookfrom, lookat, vfov=vfov, aspect=w / h)
    cfg = RenderConfig(backend=backend, seed=0,
                       interpret=backend == "sweep")
    img = np.asarray(render(scene, cam, w, h, cfg))
    ref = oracle_render(scene, lookfrom, lookat, w, h, vfov=vfov)
    diff = np.abs(img - ref).max(axis=-1)
    frac_close = float(np.mean(diff <= 1e-3))
    return img, ref, diff, frac_close


class TestOracleParity:
    @pytest.mark.parametrize("backend", ["jnp", "mxu", "sweep", "auto"])
    def test_cornell_pixels(self, backend):
        scene = cornell_box()
        img, ref, diff, frac = _compare(
            scene, (0, 1, 2), (0, 1, 0), 48, 36, backend)
        assert frac >= 0.99, f"only {frac:.4f} of pixels within 1e-3"
        # The disagreeing tail must be isolated boundary pixels, not a
        # systematic shift.
        assert float(np.mean(diff)) < 5e-3

    def test_sphere_scene_pixels(self):
        scene = sphere_plane_scene()
        img, ref, diff, frac = _compare(
            scene, (0, 2, 6), (0, 1, 0), 40, 40, "jnp")
        assert frac >= 0.99, f"only {frac:.4f} of pixels within 1e-3"

    def test_oracle_sees_the_scene(self):
        # Guard against a vacuously-black oracle.
        ref = oracle_render(cornell_box(), (0, 1, 2), (0, 1, 0), 32, 24)
        assert ref.max() > 0.2
        assert float((ref.max(axis=-1) > 0.01).mean()) > 0.5


# Golden single-pixel values: the C++-exact shading arithmetic evaluated
# by the committed scalar NumPy oracle at seed 0 on the canonical Cornell
# view (48x36, eye (0,1,2), look (0,1,0)), captured 2026-08-18 at pixels
# chosen away from eps-window/silhouette boundaries (flat 3x3
# neighborhoods). The whole 48x36 frame agreed with the jnp backend to
# max|diff| = 3.6e-7 at capture time; these constants pin that claim so
# ANY drift in the shading math (framework or oracle) fails loudly.
_GOLDEN_PIXELS = [
    # (row, col, (r, g, b))
    (2, 27, (0.0, 0.0, 0.0)),          # ceiling in shadow term
    (32, 22, (0.0, 0.0, 0.0)),         # floor shadow
    (23, 7, (0.828039, 0.08543259, 0.065717384)),    # left wall (red)
    (23, 2, (0.78562057, 0.08105609, 0.06235084)),   # left wall, grazing
    (8, 2, (0.64704645, 0.06675875, 0.051352892)),   # left wall, upper
    (11, 37, (0.15261026, 0.49053296, 0.09919667)),  # right wall (green)
]


# The committed wide grid (VERDICT r4 item 6: >= 64 pixels): every flat
# 3x3-neighborhood pixel of the 48x36 frame where oracle and framework
# agreed to <= 1e-5 at capture time — 196 coordinates, regenerated by
# scripts/make_golden_pixels.py. The 6 inline constants above stay as the
# human-readable anchor; the grid makes a shading-math regression at ANY
# of 196 scattered surface points fail loudly.
_GRID = os.path.join(os.path.dirname(__file__), "golden",
                     "cornell_pixels_48x36.npz")


class TestGoldenPixels:
    """Bit-level single-pixel parity (VERDICT r2 item 9, widened per r4
    item 6): fixed seed, stable pixels, hard-coded expectations."""

    @pytest.fixture(scope="class")
    def cornell_img(self):
        scene = cornell_box()
        cam = Camera.look_at((0, 1, 2), (0, 1, 0), vfov=60.0, aspect=48 / 36)
        return np.asarray(render(scene, cam, 48, 36,
                                 RenderConfig(backend="jnp", seed=0)))

    @pytest.fixture(scope="class")
    def grid(self):
        data = np.load(_GRID)
        return data["rows"], data["cols"], data["rgb"]

    def test_framework_matches_golden_constants(self, cornell_img):
        for row, col, rgb in _GOLDEN_PIXELS:
            np.testing.assert_allclose(
                cornell_img[row, col], np.asarray(rgb, np.float32),
                atol=2e-6, rtol=0,
                err_msg=f"pixel ({row},{col}) drifted from the committed "
                        "C++-exact oracle value")

    def test_oracle_still_produces_golden_constants(self):
        # The oracle itself is pinned too: if both it and the framework
        # drift together, this catches the oracle side.
        ref = oracle_render(cornell_box(), (0, 1, 2), (0, 1, 0), 48, 36)
        for row, col, rgb in _GOLDEN_PIXELS:
            np.testing.assert_allclose(
                ref[row, col], np.asarray(rgb, np.float32), atol=2e-6, rtol=0,
                err_msg=f"oracle pixel ({row},{col}) drifted")

    def test_framework_matches_golden_grid(self, cornell_img, grid):
        rows, cols, rgb = grid
        assert len(rows) >= 64
        got = cornell_img[rows, cols]
        bad = np.abs(got - rgb).max(-1) > 5e-6
        assert not bad.any(), (
            f"{bad.sum()} of {len(rows)} pinned pixels drifted; first at "
            f"({rows[bad][0]},{cols[bad][0]})")

    def test_oracle_matches_golden_grid(self, grid):
        rows, cols, rgb = grid
        ref = oracle_render(cornell_box(), (0, 1, 2), (0, 1, 0), 48, 36)
        got = ref[rows, cols]
        bad = np.abs(got - rgb).max(-1) > 2e-6
        assert not bad.any(), (
            f"{bad.sum()} of {len(rows)} pinned oracle pixels drifted; "
            f"first at ({rows[bad][0]},{cols[bad][0]})")
