"""Real multi-process `jax.distributed` exercise (2 CPU processes).

Everything else in tests/test_parallel.py runs on a single-process virtual
mesh; this spawns two OS processes with their own JAX runtimes, forms an
8-device mesh whose `space` axis crosses the process boundary, and checks
the sharded block-matching step (halo `ppermute` + WTA `pmin` across the
distributed transport) is bit-identical to a single-device run — the
mechanics the multi-host scaling target depends on (SURVEY §2.5).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(REPO, "tools", "dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_block_matching():
    port = _free_port()
    env = dict(os.environ)
    # A clean CPU JAX in the children: the repo alone on the path, and no
    # inherited coordinator/backend state.
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert "bit-identical to single-device" in out
