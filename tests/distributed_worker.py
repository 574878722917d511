"""Worker for the 2-process multi-host smoke test (test_distributed.py).

Each process owns 2 virtual CPU devices; ``jax.distributed.initialize``
(through the framework's ``init_distributed`` entry) joins them into one
4-device global mesh, and a real ``train_step_sharded`` runs over it —
ray shards on remote-process devices included, gradients psum'd across
the process boundary. This exercises the multi-host bring-up path the
reference only stubbed (its dead CONFIG_MPI hook,
reference cmake/config.cmake:76-78).

Usage: python distributed_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

# init_distributed must run before anything touches the XLA backend —
# importing the framework builds fixture pytrees at module scope, so the
# distributed bring-up comes first (exactly the real pod-slice order).
from esctp1raytracer_tpu.parallel.distributed import init_distributed  # noqa: E402

n = init_distributed(f"localhost:{port}", nproc, pid)

import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu import Camera, RenderConfig  # noqa: E402
from esctp1raytracer_tpu.parallel import make_mesh, train_step_sharded  # noqa: E402
from esctp1raytracer_tpu.scene.builders import sphere_plane_scene  # noqa: E402

assert n == nproc, f"process_count {n} != {nproc}"
assert jax.process_index() == pid
assert jax.local_device_count() == 2, jax.local_device_count()
assert jax.device_count() == 2 * nproc, jax.device_count()

mesh = make_mesh(jax.devices(), rays=2 * nproc, prims=1)
scene = sphere_plane_scene()
cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0)
target = jnp.zeros((8, 8, 3), jnp.float32)

new_scene, loss = train_step_sharded(
    scene, target, cam, lr=1e-3, cfg=RenderConfig(backend="jnp"), mesh=mesh)
jax.block_until_ready((new_scene, loss))
loss = float(loss)  # replicated out_spec: addressable on every process
assert np.isfinite(loss), loss
# The update must have moved the float params (non-trivial gradient).
moved = any(
    not np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(scene), jax.tree.leaves(new_scene))
)
assert moved, "SGD step changed no parameter"
print(f"DIST_OK pid={pid} loss={loss:.6f}", flush=True)
