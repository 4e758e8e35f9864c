"""Multi-host bring-up: exercise ``parallel.mesh.initialize_distributed``
with a real 2-process jax.distributed cluster on CPU (jax.distributed
supports CPU multi-process — the same code path that brings up several
GPU hosts, SURVEY.md §2.13).

Runs each process as a subprocess so the coordinator/client lifecycle and
the collective actually cross process boundaries.
"""

import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent(
    """
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")

    from crucible_tpu.parallel import mesh as mesh_mod

    coord, pid = sys.argv[1], int(sys.argv[2])
    mesh_mod.initialize_distributed(
        coordinator=coord, num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.process_index() == pid

    # A real cross-process collective: global device count spans both
    # processes and a psum over the global mesh reduces across them.
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    # Global devices span both processes (local count depends on the
    # inherited xla_force_host_platform_device_count flag).
    assert jax.device_count() == 2 * jax.local_device_count()
    val = multihost_utils.process_allgather(jnp.asarray([pid + 1.0]))
    assert float(val.sum()) == 3.0, val  # 1.0 (pid 0) + 2.0 (pid 1)
    print(f"OK{pid}", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cpu_cluster(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out.decode(), err.decode()))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{err[-2000:]}"
        assert f"OK{pid}" in out


def test_initialize_distributed_single_process_noop():
    from crucible_tpu.parallel import mesh as mesh_mod

    # num_processes <= 1 must be a no-op (the single-host path).
    mesh_mod.initialize_distributed(num_processes=1)
    mesh_mod.initialize_distributed()
