"""The port's process-group transport across processes (counterpart of
``tests/test_multiprocess_mesh.py``): two gloo ranks run distributed q1,
its shuffle's all-to-all crossing the process boundary, and each checks
the result against the local mesh's and the numpy oracle
(``tests/torch_multiproc_worker.py``, which imports only the port)."""

import os
import subprocess
import sys

WORLD, ROWS_PER_RANK = 2, 512


def test_q1_shuffle_crosses_process_boundaries(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    init_file = tmp_path / "pg"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests.torch_multiproc_worker",
             str(rank), str(WORLD), str(init_file), str(ROWS_PER_RANK)],
            cwd=repo, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for rank in range(WORLD)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.strip().splitlines()[-15:])
        assert p.returncode == 0, f"rank {rank} failed:\n{tail}"
        assert "TORCH_Q1_MULTIPROC_MATCH" in out, f"rank {rank}:\n{tail}"
