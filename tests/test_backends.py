"""Backend routing by platform, the sweep kernel through render / grad /
shard_map (interpret mode), and chip_smoke.py's refusal without a GPU."""

import importlib
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esctp1raytracer_tpu import Camera, RenderConfig, cornell_box, mixed_scene, render
from esctp1raytracer_tpu.core.render import resolve_backend
from esctp1raytracer_tpu.parallel import (
    float_params, loss_and_grad_sharded, make_mesh, merge_params,
    render_sharded)

render_mod = importlib.import_module("esctp1raytracer_tpu.core.render")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = Camera.look_at((0, 1, 2), (0, 1, 0), aspect=1.0)
SWEEP = RenderConfig(backend="sweep", interpret=True)


def _on(monkeypatch, platform):
    monkeypatch.setattr(render_mod.jax, "default_backend", lambda: platform)


@pytest.mark.parametrize("platform,want", [("cpu", "jnp"), ("gpu", "sweep")])
def test_auto_resolves_by_platform(monkeypatch, platform, want):
    _on(monkeypatch, platform)
    assert resolve_backend(RenderConfig(backend="auto")) == want


def test_auto_on_other_platform_raises(monkeypatch):
    _on(monkeypatch, "metal")
    with pytest.raises(ValueError, match="no route"):
        resolve_backend(RenderConfig(backend="auto"))


@pytest.mark.parametrize("name,replacement", [
    ("lane", "sweep"), ("tile", "sweep"), ("mxtile", "sweep"),
    ("fused", "auto"), ("pallas", "auto")])
def test_removed_backends_name_their_replacement(name, replacement):
    with pytest.raises(ValueError, match=f"removed; use '{replacement}'"):
        resolve_backend(RenderConfig(backend=name))


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend(RenderConfig(backend="bvh"))


@pytest.mark.parametrize("backend", ["jnp", "mxu"])
def test_xla_backends_resolve_to_themselves(backend):
    assert resolve_backend(RenderConfig(backend=backend)) == backend


def test_sweep_on_cpu_needs_interpret():
    with pytest.raises(ValueError, match="interpret=True"):
        resolve_backend(RenderConfig(backend="sweep"))
    with pytest.raises(ValueError, match="interpret=True"):
        render(cornell_box(), CAM, 8, 8, RenderConfig(backend="sweep"))
    assert resolve_backend(SWEEP) == "sweep"


def test_sweep_on_gpu_compiles_without_interpret(monkeypatch):
    """On "gpu" the hook is the compiled kernel, never the interpreter."""
    _on(monkeypatch, "gpu")
    search, use_mxu = render_mod._search_fns(RenderConfig(backend="auto"))
    assert search.interpret is False and use_mxu is False


def _images_match(a, b):
    diff = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    assert (diff > 1e-3).mean() < 0.005


@pytest.mark.parametrize("depth", [1, 2])
def test_render_matches_jnp(depth):
    scene = mixed_scene()
    cam = Camera.look_at((0, 2.5, 7), (0, 1, 0), aspect=1.0)
    a = render(scene, cam, 24, 24, RenderConfig(backend="jnp", depth=depth))
    b = render(scene, cam, 24, 24, SWEEP.replace(depth=depth))
    _images_match(a, b)


@pytest.mark.parametrize("which", ["cornell", "mixed_depth2"])
def test_grad_through_render_matches_jnp(which):
    """The search runs under stop_gradient, so wherever the two searches
    pick the same primary winner the gradients are the jnp backend's.
    Pixels whose winner flips in the eps band (quirk 16) are masked."""
    from esctp1raytracer_tpu.core.intersect import EPS, argmin_hit
    from esctp1raytracer_tpu.kernels.sweep_gpu import SweepSearch

    if which == "cornell":
        scene, cam, depth = cornell_box(), CAM, 1
    else:
        scene = mixed_scene()
        cam = Camera.look_at((0, 2.5, 7), (0, 1, 0), aspect=1.0)
        depth = 2
    o, d = cam.ray_grid(16, 16)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    _, p_k, _ = argmin_hit(o, d, scene, EPS,
                           tri_search=SweepSearch(interpret=True))
    _, p_j, _ = argmin_hit(o, d, scene, EPS, use_mxu=False)
    agree = (p_k == p_j).reshape(16, 16, 1)
    params = float_params(scene)

    def grads(cfg):
        def loss(ps):
            img = render(merge_params(scene, ps), cam, 16, 16, cfg)
            return jnp.sum(jnp.where(agree, img * img, 0.0))
        return jax.grad(loss)(params)

    g_k = grads(SWEEP.replace(depth=depth))
    g_j = grads(RenderConfig(backend="jnp", depth=depth))
    for a, b in zip(g_k, g_j):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all()
        nb = np.linalg.norm(b)
        assert np.linalg.norm(a - b) <= 1e-3 * max(nb, 1e-6)


def test_sharded_sweep_matches_unsharded(eight_devices):
    scene = cornell_box()
    a = render(scene, CAM, 32, 32, SWEEP)
    b = render_sharded(scene, CAM, 32, 32, SWEEP, make_mesh(rays=8))
    _images_match(a, b)


def test_sharded_sweep_grad(eight_devices):
    """The kernel under shard_map on a rays-only mesh: psum'd gradients
    match the unsharded jax.grad."""
    scene = cornell_box()
    target = jnp.zeros((16, 16, 3), jnp.float32)
    loss_s, grads_s = loss_and_grad_sharded(scene, target, CAM, cfg=SWEEP,
                                            mesh=make_mesh(rays=8))

    def loss_fn(ps):
        img = render(merge_params(scene, ps), CAM, 16, 16, SWEEP)
        return jnp.mean((img - target) ** 2)

    loss_u, grads_u = jax.value_and_grad(loss_fn)(float_params(scene))
    np.testing.assert_allclose(float(loss_s), float(loss_u), rtol=1e-5)
    for gs, gu in zip(grads_s, grads_u):
        gs, gu = np.asarray(gs), np.asarray(gu)
        scale = max(np.abs(gu).max(), 1e-6)
        np.testing.assert_allclose(gs, gu, atol=3e-4 * scale, rtol=3e-3)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_sweep_compiled_on_card(gpu_device):
    """The compiled kernel (no interpreter) against the reference."""
    from esctp1raytracer_tpu.core.intersect import EPS, argmin_hit
    from esctp1raytracer_tpu.kernels.sweep_gpu import SweepSearch

    scene = cornell_box()
    o, d = CAM.ray_grid(64, 64)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    _, p_ref, _ = argmin_hit(o, d, scene, EPS, use_mxu=False)
    _, p = SweepSearch()(o, d, scene.triangles, EPS)
    assert (np.asarray(p) == np.asarray(p_ref)).mean() >= 0.995
