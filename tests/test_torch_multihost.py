"""Multi-host scale-out of lk_tpu_torch: a 2-process CPU cluster over
torch.distributed (gloo), as tests/test_multihost.py runs lk_tpu's.

Two real OS processes (tests/torch_multihost_worker.py), one rank each, one
thread each, on a free localhost port; each owns half of a global data
mesh's stream batch and checks the sharded pipeline against the
single-process baseline on the rows it owns.
"""

import os
import socket
import subprocess
import sys

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_stream_sharded_pipeline():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK {pid}" in out, out[-3000:]
    # each process owned a distinct, contiguous half of the stream batch
    assert "rows=0:4" in outs[0] and "rows=4:8" in outs[1]
