"""End-to-end render tests: golden statistics, cross-backend agreement,
determinism — the framework's version of the reference's golden-image
strategy matrix (scripts/run.sh renders the same scene under all execution
strategies and compares; SURVEY.md §4)."""

import numpy as np
import pytest

from esctp1raytracer_tpu import (
    Camera,
    RenderConfig,
    cornell_box,
    mixed_scene,
    render,
    sphere_plane_scene,
    ten_sphere_scene,
)

CAM = Camera.look_at((0, 1, 2), (0, 1, 0), aspect=1.0)


@pytest.fixture(scope="module")
def cornell():
    return cornell_box()


def _img(scene, cam, n=64, cfg=RenderConfig()):
    return np.asarray(render(scene, cam, n, n, cfg))


class TestCornell:
    def test_image_statistics(self, cornell):
        img = _img(cornell, CAM)
        assert img.shape == (64, 64, 3)
        assert np.isfinite(img).all()
        assert img.min() >= 0.0
        lit = (img.sum(-1) > 0).mean()
        assert 0.4 < lit < 0.95  # shadowed regions exist, most pixels lit

    def test_fully_lit_surfaces_saturate(self, cornell):
        img = _img(cornell, CAM)
        # White walls under direct light exceed 1.0 pre-clamp (ka*0.5 + kd
        # with kd=ka=0.725 and d~1), and nothing explodes. Note the
        # emissive panel itself renders dark — faithful to the reference,
        # whose emission term is gated on light visibility with d > 0
        # (src/main.cpp:769-783), near-impossible for a point on the light.
        assert img.max() > 1.0
        assert img.max() < 5.0

    def test_left_wall_red_right_wall_green(self, cornell):
        img = _img(cornell, CAM)
        left = img[20:44, 2:6].mean(axis=(0, 1))
        right = img[20:44, 58:62].mean(axis=(0, 1))
        assert left[0] > left[1] * 2  # red dominates
        assert right[1] > right[0] * 2  # green dominates

    def test_deterministic(self, cornell):
        a = _img(cornell, CAM)
        b = _img(cornell, CAM)
        np.testing.assert_array_equal(a, b)

    def test_seed_changes_sampling(self, cornell):
        a = _img(cornell, CAM)
        b = _img(cornell, CAM, cfg=RenderConfig(seed=7))
        assert np.abs(a - b).max() > 0  # light sampling is stochastic

    def test_backends_agree(self, cornell):
        a = _img(cornell, CAM, cfg=RenderConfig(backend="jnp"))
        b = _img(cornell, CAM, cfg=RenderConfig(backend="mxu"))
        # Borderline eps-window pixels may flip; the rest must match tightly.
        diff = np.abs(a - b).max(-1)
        assert (diff > 1e-3).mean() < 0.005
        assert np.median(diff) < 1e-5

    def test_ray_chunking_matches(self, cornell):
        # Counter-based RNG keyed on the global ray id makes chunked and
        # unchunked renders sample identically; only XLA reassociation
        # noise (different fusion decisions) remains.
        a = _img(cornell, CAM)
        b = _img(cornell, CAM, cfg=RenderConfig(ray_chunk=1024))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_block_size_invariance(self, cornell):
        a = _img(cornell, CAM, cfg=RenderConfig(block_size=256))
        b = _img(cornell, CAM, cfg=RenderConfig(block_size=64))
        np.testing.assert_allclose(a, b, atol=1e-6)


class TestSphereScenes:
    def test_sphere_plane(self):
        img = _img(sphere_plane_scene(), Camera.look_at((0, 2, 6), (0, 1, 0), aspect=1.0))
        assert np.isfinite(img).all()
        assert (img.sum(-1) > 0).mean() > 0.3
        # The sphere occupies the image center and is red-ish.
        c = img[28:36, 28:36].mean(axis=(0, 1))
        assert c[0] > c[2]

    def test_ten_spheres(self):
        img = _img(ten_sphere_scene(), Camera.look_at((0, 4, 8), (0, 0.5, 0), aspect=1.0))
        assert np.isfinite(img).all()
        assert (img.sum(-1) > 0).mean() > 0.3

    def test_depth_adds_reflection_energy(self):
        scene = mixed_scene()
        cam = Camera.look_at((0, 2.5, 7), (0, 1, 0), aspect=1.0)
        d1 = _img(scene, cam, cfg=RenderConfig(depth=1))
        d4 = _img(scene, cam, cfg=RenderConfig(depth=4))
        assert np.isfinite(d4).all()
        assert d4.sum() > d1.sum()  # reflections only add energy

    def test_shadows_exist(self):
        # A sphere between the light and the ground must darken the ground.
        scene = sphere_plane_scene()
        cam = Camera.look_at((0, 3, 7), (0, 0.5, 0), aspect=1.0)
        img = _img(scene, cam, 96)
        ground = img[: 40]  # lower rows = ground (t small)
        lit_vals = ground.sum(-1)
        hit_ground = lit_vals >= 0  # all rows
        assert (lit_vals[hit_ground] == 0).any() or lit_vals.std() > 0.05


class TestAutoBackend:
    def test_auto_renders(self, cornell):
        img = _img(cornell, CAM, 32, RenderConfig(backend="auto"))
        assert np.isfinite(img).all() and img.max() > 0
