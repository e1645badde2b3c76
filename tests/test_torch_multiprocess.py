"""Multi-process runs of the port on the CPU: fleets of
``python -m repro_torch.launch.train`` processes racing on one spool
(tests/mp_harness.py, as tests/test_multiprocess.py drives the JAX
trainer), and the torch.distributed AllGatherTransport across two
``gloo`` processes. The job report a fleet publishes must equal the
in-process merge of the same per-rank payloads byte for byte."""

import json
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from mp_harness import REPO_ROOT, fleet_env, free_port, launch_fleet  # noqa: E402

from repro_torch.core.merge import (  # noqa: E402
    InProcessGather,
    load_spool_payload,
    merge_results,
)
from repro_torch.core.report import to_json  # noqa: E402

DRIVER = "repro_torch.launch.train"
CPU = ("--device", "cpu")


def test_three_rank_fleet_matches_in_process_merge(tmp_path):
    """Three trainer processes with a step series, the watchdog and a
    sample every step: each spools its report and steps, the last merges
    talp_job.json, which equals InProcessGather's merge of the payloads."""
    from repro_torch.core.merge import FileSpoolTransport

    spool = tmp_path / "spool"
    res = launch_fleet(str(spool), n_ranks=3, driver=DRIVER,
                       extra_args=(*CPU, "--talp-step-series", "3",
                                   "--talp-watchdog", "--talp-sample-every",
                                   "1"))
    assert res.ok, res.report()
    gather = InProcessGather(world_size=3)
    for rank in range(3):
        payload = spool / f"talp_rank{rank:05d}.npz"
        gather.submit(load_spool_payload(str(payload))[0], rank=rank)
    job_json = (spool / "talp_job.json").read_text()
    assert job_json == to_json(gather.merge(name="train"))
    g = json.loads(job_json)["regions"]["Global"]
    assert len(g["host_states"]) == 3
    assert g["host_metrics"]["parallel_efficiency"] > 0
    transport = FileSpoolTransport(str(spool))
    assert sorted(transport.sampled_ranks()) == [0, 1, 2]
    assert {r: len(s) for r, s in transport.collect_steps().items()} == {
        0: 3, 1: 3, 2: 3}
    assert len(transport.merge_steps()) == 3


def test_fault_injected_fleet_partial_merge(tmp_path):
    """Rank 2 drops its submit and rank 1's payload is cut to 200 bytes by
    --talp-fault-plan: every process exits 0, none can merge, and the
    port's merge CLI merges rank 0 alone with a rank_coverage naming the
    losses, its regions those of a clean merge of rank 0."""
    spool = tmp_path / "spool"
    plan = json.dumps({"drop": [2], "truncate": {"1": 200}})
    res = launch_fleet(str(spool), n_ranks=3, driver=DRIVER,
                       extra_args=(*CPU, "--talp-fault-plan", plan))
    assert res.ok, res.report()
    assert not (spool / "talp_job.json").exists()
    assert not (spool / "talp_rank00002.npz").exists()
    survivor = load_spool_payload(str(spool / "talp_rank00000.npz"))[0]
    reference = json.loads(to_json(merge_results([survivor], name="job")))
    out = tmp_path / "job.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.merge", str(spool),
         "--name", "job", "--allow-missing-ranks", "--expected-ranks", "3",
         "--json-out", str(out)],
        capture_output=True, text=True, env=fleet_env(), cwd=REPO_ROOT,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "partial job report" in proc.stderr
    job = json.loads(out.read_text())
    cov = job["rank_coverage"]
    assert cov["expected"] == 3 and cov["merged"] == [0]
    assert cov["missing"] == [2]
    assert [q["rank"] for q in cov["quarantined"]] == [1]
    assert job["regions"] == reference["regions"]
    assert (spool / "quarantine" / "talp_rank00001.npz").exists()


# Every process of the gloo fleet: join the group, build the same
# deterministic per-rank result as _rank_result, gather, write the job.
_GLOO_WORKER = r"""
import sys
rank, world, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.core.merge import AllGatherTransport
from repro_torch.core.report import to_json
from test_torch_multiprocess import _rank_result
job = AllGatherTransport().gather(_rank_result(rank), name="job")
with open(out_path, "w") as f:
    f.write(to_json(job))
dist.destroy_process_group()
"""


def _rank_result(rank):
    from repro_torch.core import DeviceActivity, TalpMonitor

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clk = Clock()
    mon = TalpMonitor(f"rank{rank}", rank=rank, clock=clk)
    with mon.region("step"):
        clk.t += 1.0 + rank
        with mon.offload():
            clk.t += 0.5
    mon.add_device_record(0, DeviceActivity.KERNEL, 0.0, 0.25 * (rank + 1))
    return mon.finalize()


def test_allgather_transport_two_gloo_processes(tmp_path):
    """Two processes of a gloo group exchange their results through
    all_gather_object: both obtain the same job report, equal to
    merge_results of the same per-rank results in this process."""
    env = fleet_env()
    env["PYTHONPATH"] = f"{REPO_ROOT}/tests:{env['PYTHONPATH']}"
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(rank), "2", port,
         str(tmp_path / f"job_rank{rank}.json")],
        env=env, cwd=REPO_ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in range(2)]
    for proc in procs:
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-3000:]
    jobs = [(tmp_path / f"job_rank{r}.json").read_text() for r in range(2)]
    assert jobs[0] == jobs[1]
    want = to_json(merge_results([_rank_result(0), _rank_result(1)],
                                 name="job"))
    assert jobs[0] == want
    assert len(json.loads(want)["regions"]["Global"]["host_states"]) == 2
