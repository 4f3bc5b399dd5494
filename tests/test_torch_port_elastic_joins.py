"""Port: joiners of a running elastic job on the CPU, under the port's
elastic driver (the jobs of tests/test_torch_port_elastic_jobs.py, its
worker and its fake cluster).

- A joiner whose host sorts before the survivor's becomes rank 0 (the
  driver gives out ranks in host-name order, as the JAX package's
  does): the sync broadcasts from the survivor, the lowest rank that
  holds the job's state, and its last commit survives.
- A joiner that dies before its bootstrap: the survivor's bootstrap of
  that generation times out (`basics._bootstrap_timeout`), and the
  reset's retry joins the generation the driver published without it.
"""

import time

import pytest

from horovod_tpu_torch.common.basics import ELASTIC_BOOTSTRAP_MARGIN_S
from test_torch_port_collectives import no_launcher_env  # noqa: F401
from test_torch_port_elastic_jobs import ElasticJob, _commits


def test_a_joiner_that_sorts_first_takes_the_survivors_state(tmp_path):
    """hostA joins hostB's running job and becomes rank 0 (the driver
    gives out ranks in host-name order): the sync broadcasts from the
    survivor, rank 1, and its last commit (parameters, momentum, epoch)
    survives."""
    job = ElasticJob(tmp_path, [("hostB", 1)], num_epochs=14,
                     epoch_time=0.3, max_np=2)
    job.wait_for("hostB-0", "commit", min_epoch=1)
    job.set_hosts([("hostA", 1), ("hostB", 1)])
    rc, out = job.wait()
    assert rc == 0, out
    hist = job.histories()
    joiner, survivor = hist["hostA-0"], hist["hostB-0"]
    enter_j = joiner[0]
    assert enter_j["event"] == "enter" and enter_j["gen"] >= 1
    assert enter_j["joining"] and enter_j["rank"] == 0
    enter_s = [r for r in survivor if r["event"] == "enter" and r["gen"] ==
               enter_j["gen"]][0]
    assert enter_s["rank"] == 1 and enter_s["resets"] == 1
    last_commit = [r for r in _commits(survivor)
                   if r["t"] < enter_s["t"]][-1]
    assert enter_j["digest"] == enter_s["digest"] == last_commit["digest"]
    assert enter_j["epoch"] == enter_s["epoch"] == last_commit["epoch"] >= 1
    assert joiner[-1]["event"] == survivor[-1]["event"] == "exit"
    assert joiner[-1]["digest"] == survivor[-1]["digest"]
    assert max(r["epoch"] for r in survivor) == 14


@pytest.mark.parametrize("joiner", ["hostA", "hostC"],
                         ids=["joiner_rank0", "joiner_rank1"])
def test_a_joiner_that_dies_before_its_bootstrap_frees_the_survivor(
        tmp_path, joiner):
    """The joiner exits 1 before `hvd.init`.  The survivor waits in the
    new generation's bootstrap (for the joiner's store as rank 1, or for
    the joiner in the process group as rank 0) for the driver's deadline
    of a silent new worker plus a margin (`basics._bootstrap_timeout`),
    not the store's 30 minutes; then its reset's retry joins the
    generation the driver published without the joiner's host, and it
    finishes alone from its last commit.  No lease here (TTL 0): the
    timeout is the start grace, 2 s, plus the margin."""
    timeout = 2 + ELASTIC_BOOTSTRAP_MARGIN_S
    job = ElasticJob(tmp_path, [("hostB", 1)], num_epochs=10,
                     epoch_time=0.3, max_np=2, extra_env={
                         "EXIT_BEFORE_INIT": joiner,
                         "HOROVOD_ELASTIC_START_GRACE": "2",
                         "HOROVOD_ELASTIC_LEASE_TTL": "0"})
    job.wait_for("hostB-0", "commit", min_epoch=1)
    t_grow = time.time()
    job.set_hosts([("hostB", 1), (joiner, 1)])
    rc, out = job.wait(timeout=90)
    assert rc == 0, out
    assert f"blacklisting host {joiner}" in out and "DEGRADED" in out, out
    hist = job.histories()
    assert sorted(hist) == ["hostB-0"]  # the joiner never reached init
    b = hist["hostB-0"]
    enters = [r for r in b if r["event"] == "enter"]
    assert [(r["size"], r["resets"]) for r in enters] == [(1, 0), (1, 1)]
    assert enters[1]["gen"] >= 2
    last = [r for r in _commits(b) if r["t"] < enters[1]["t"]][-1]
    assert enters[1]["digest"] == last["digest"]
    # A store client retries its connection once, after a backoff,
    # within about twice its timeout.
    assert enters[1]["t"] - t_grow < 3 * timeout + 10
    assert b[-1]["event"] == "exit" and max(r["epoch"] for r in b) == 10
