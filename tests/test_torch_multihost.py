"""Two processes of the port started the way a launcher starts them: each
reads MSLAM_COORDINATOR / MSLAM_NUM_PROCESSES / MSLAM_PROCESS_ID in
`parallel.distributed.initialize` (gloo on the CPU, a file rendezvous so
that parallel test workers never share a port), builds the same seeded
problem and runs the sharded CG solver over the global mesh
(`port_util.multihost_rank`; the counterpart of the reference's
`tests/test_multihost.py`)."""

import json
import os
import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def test_two_process_distributed_ba(tmp_path):
    procs = []
    for pid in range(2):
        env = dict(os.environ, MSLAM_COORDINATOR=f"file://{tmp_path}/rendezvous",
                   MSLAM_NUM_PROCESSES="2", MSLAM_PROCESS_ID=str(pid),
                   PYTHONPATH=os.pathsep.join([str(TESTS.parent), str(TESTS)]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import port_util; port_util.multihost_rank()"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(TESTS.parent)))
    reports = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
        reports += [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                    if line.startswith("MULTIHOST_REPORT ")]
    assert sorted(r["process_id"] for r in reports) == [0, 1]
    for r in reports:
        assert r["process_count"] == 2 and r["mesh_model"] == 2 and r["multi"] is True
        assert r["chi2_final"] < r["chi2_initial"]
    assert reports[0]["chi2_final"] == reports[1]["chi2_final"]
