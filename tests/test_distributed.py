"""Process-level multi-host bring-up: 2 real processes, one global mesh.

The BASELINE scaling plan is "1 chip -> 1 host -> >=2 hosts"; the
reference's only analogue is a dead CONFIG_MPI compile hook
(reference cmake/config.cmake:76-78). Here ``init_distributed``
(parallel/distributed.py) is exercised for real: two local processes
join through a localhost coordinator, each contributing 2 virtual CPU
devices to a 4-device global mesh, and one sharded SGD train step runs
across the process boundary (ray shards on non-addressable devices,
psum'd gradients). This is the closest a single machine gets to a pod
slice and covers the code path no single-process test can reach.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "distributed_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_train_step():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS",
                        "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_REPO)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"DIST_OK pid={pid}" in out, out
    # Replicated loss must agree bit-for-bit across processes.
    losses = {line.split("loss=")[1] for out in outs for line in out.splitlines()
              if line.startswith("DIST_OK")}
    assert len(losses) == 1, f"processes disagree on the loss: {losses}"
