"""``main_found_avmnist --use_dataparallel`` on two gloo ranks against the
same command on one rank and the JAX CLI on its 8-device mesh, on the CPU
(the counterpart of tests/test_multihost.py:293).

The ranks join their group before the CLI runs (tests/torch_ranks.py), as
a caller that has already initialised a default group does; the CLI uses
it. Found conf 0 at --channels 4, --batchsize 8, --drpt 0, 2 epochs, the
JAX net's initial weights, on tests/test_torch_found_avmnist.py's store:
both ranks print the same epoch losses and accuracies and the same Model
Acc, which equals the one-rank run's and the JAX CLI's; only rank 0 writes
--save_checkpoint.
"""

import os
import sys

import pytest

import main_found_avmnist as jmain
from tests.test_torch_found_avmnist import fx  # noqa: F401 (fixture)
from tests.torch_ranks import found_avmnist_cli, run_ranks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under a parallel test runner every split op
    waits on threads the other workers' processes hold."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dataparallel_cli_on_two_ranks_matches_one_and_jax(fx, tmp_path,
                                                           capsys):
    argv = fx["argv"] + ["--epochs", "2", "--use_dataparallel"]
    two = run_ranks(2, ["cli_avmnist"],
                    {"argv": argv + ["--checkpointdir", str(tmp_path),
                                     "--save_checkpoint"],
                     "flat": fx["flat"]}, tmp_path / "ranks")
    got = [r["cli_avmnist"] for r in two]
    one = found_avmnist_cli(argv, fx["flat"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["main_found_avmnist.py", *argv])
        jmain.main()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Model Acc:")]
    acc_j = float(line[-1].split(":")[1])
    assert got[0]["acc"] == got[1]["acc"] == one["acc"] == acc_j
    assert got[0]["epochs"] == got[1]["epochs"]
    for a, b in zip(got[0]["epochs"], one["epochs"]):
        assert [e["acc"] for e in a] == [e["acc"] for e in b]
    assert got[0]["saved"] and os.path.exists(got[0]["saved"])
    assert got[1]["saved"] is None
