"""The port's chaos drill (``poisson_ellipse_tpu_torch.serve.chaos``) against
the JAX package's ``serve.chaos``, on the CPU.

``run_chaos`` at its own defaults (50 requests of 10x10, 12x12 and 8x8,
4 lanes, chunk 8: a NaN lane at request 2, an OOM at request 5, a kill
at the stream's half with journal replay), with and without the
device-loss drill, for seeds 0 and 1 and at the JAX tests' own seeds:
the counts, per-request outcomes, ``replayed``, ``faults_fired``,
``killed``, ``mesh_killed`` and ``ok`` equal JAX's, and the JSON record
carries JAX's keys. (No deadline runs here: with one, outcomes follow the
wall clock in both packages.)
"""

import json
import os

import pytest
import torch

from poisson_ellipse_tpu.harness.__main__ import main as jax_main
from poisson_ellipse_tpu.obs import metrics as jax_metrics
from poisson_ellipse_tpu.obs import trace as jax_trace
from poisson_ellipse_tpu.serve import chaos as jax_chaos
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.obs import metrics as obs_metrics
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.serve import chaos

COMPARED = ("n_requests", "outcomes", "counts", "lost", "double_completed",
            "unclassified", "replayed", "killed", "faults_fired",
            "mesh_killed", "ok")


@pytest.fixture(autouse=True)
def one_torch_thread_and_no_tracer():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (obs_trace, jax_trace):
        mod.stop()
        mod._env_checked = True
    yield
    obs_trace.stop()
    jax_trace.stop()
    for reg in (obs_metrics.REGISTRY, jax_metrics.REGISTRY):
        reg.reset()
    torch.set_num_threads(before)


def _both(tmp_path, **kw):
    port = chaos.run_chaos(journal_path=os.path.join(tmp_path, "p.json"),
                           device="cpu", **kw)
    want = jax_chaos.run_chaos(journal_path=os.path.join(tmp_path, "j.json"),
                               **kw)
    got, ref = port.json_dict(), want.json_dict()
    assert set(got) == set(ref)
    for key in COMPARED:
        assert got[key] == ref[key], key
    return port


@pytest.mark.parametrize("mesh_kill", [None, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_run_chaos_matches_jax(tmp_path, seed, mesh_kill):
    report = _both(tmp_path, n_requests=50 if mesh_kill is None else 24,
                   seed=seed, mesh_kill_request=mesh_kill)
    assert report.ok and report.killed
    assert report.faults_fired == (2 if mesh_kill is None else 3)
    assert report.mesh_killed == (mesh_kill is not None)


def test_chaos_fifty_requests_nan_oom_kill_zero_lost(tmp_path):
    report = _both(tmp_path, n_requests=50, seed=7)
    assert report.ok, (
        f"lost={report.lost} doubled={report.double_completed} "
        f"unclassified={report.unclassified}"
    )
    assert report.killed and report.replayed >= 1
    assert report.faults_fired == 2  # the NaN lane and the fake OOM
    assert sum(report.counts.values()) == 50
    assert set(report.counts) <= {
        "completed", "cap", "failed", "deadline-miss", "shed",
    }
    assert report.outcomes["chaos-0002"] == "completed"
    assert report.outcomes["chaos-0005"] == "completed"


def test_chaos_is_seed_deterministic(tmp_path):
    r1 = chaos.run_chaos(n_requests=10, seed=3, device="cpu",
                         journal_path=os.path.join(tmp_path, "c1.json"))
    r2 = chaos.run_chaos(n_requests=10, seed=3, device="cpu",
                         journal_path=os.path.join(tmp_path, "c2.json"))
    assert r1.outcomes == r2.outcomes
    assert r1.counts == r2.counts


def test_chaos_mesh_kill_zero_lost_zero_double(tmp_path):
    report = _both(tmp_path, n_requests=24, seed=11, mesh_kill_request=5)
    assert report.ok
    assert report.mesh_killed and report.killed
    assert sum(report.counts.values()) == 24
    assert report.outcomes["chaos-0005"] in {
        "completed", "cap", "failed", "deadline-miss",
    }


def test_chaos_mesh_kill_is_seed_deterministic(tmp_path):
    kw = dict(n_requests=14, seed=5, mesh_kill_request=4, device="cpu")
    r1 = chaos.run_chaos(journal_path=os.path.join(tmp_path, "m1.json"),
                         **kw)
    r2 = chaos.run_chaos(journal_path=os.path.join(tmp_path, "m2.json"),
                         **kw)
    assert r1.outcomes == r2.outcomes
    assert r1.mesh_killed and r2.mesh_killed


def test_chaos_without_kill_needs_no_journal(tmp_path):
    port = chaos.run_chaos(n_requests=12, seed=2, kill_after=0,
                           device="cpu")
    want = jax_chaos.run_chaos(n_requests=12, seed=2, kill_after=0)
    assert not port.killed and port.replayed == 0
    assert port.counts == want.counts and port.ok == want.ok


def test_chaos_events_on_the_trace(tmp_path):
    path = tmp_path / "chaos.jsonl"
    obs_trace.start(str(path))
    try:
        report = chaos.run_chaos(n_requests=12, seed=0, device="cpu",
                                 journal_path=str(tmp_path / "j.json"))
    finally:
        obs_trace.stop()
    assert obs_trace.validate_file(str(path)) == []
    names = [r["name"] for r in obs_trace.read_jsonl(str(path))]
    assert names.count("serve:chaos-kill") == 1
    assert names.count("serve:chaos-report") == 1
    assert names.count("serve:replay") == report.replayed
    assert "serve:fault" in names


@pytest.mark.parametrize("bad", [
    {"n_requests": 0}, {"rate_per_s": 0.0},
    {"tenant_mix": [("a", 1)]}, {"class_quotas": {"a": 1}},
    {"starvation_after_s": 1.0},
])
def test_bad_arguments_raise_jax_s_error(bad):
    with pytest.raises(ValueError) as port_err:
        chaos.run_chaos(device="cpu", **bad)
    with pytest.raises(ValueError) as jax_err:
        jax_chaos.run_chaos(**bad)
    assert str(port_err.value) == str(jax_err.value)


def test_a_kill_needs_a_journal():
    with pytest.raises(ValueError) as port_err:
        chaos.run_chaos(n_requests=4, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_chaos.run_chaos(n_requests=4)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kw,item", [
    ({"replicas": 2}, "15"), ({"replica_kill": 3}, "15"),
    ({"kill_during_handoff": True}, "15"), ({"zombie": True}, "15"),
    ({"lease_s": 0.5}, "15"), ({"replica_rejoin": 4}, "15"),
    ({"replica_kill_again": 6}, "15"), ({"lease_store_outage": 2}, "15"),
    ({"malformed_request": 1}, "11"), ({"degenerate_request": 1}, "11"),
    ({"grad_requests": (1,)}, "14"), ({"warm_start": True}, "13"),
    ({"poison_request": 1}, "13"),
])
def test_unported_drills_name_their_items(kw, item):
    with pytest.raises(NotImplementedError,
                       match=f"Queue A item {item}\\)"):
        chaos.run_chaos(n_requests=4, kill_after=0, device="cpu", **kw)


def test_run_chaos_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_chaos(n_requests=2, kill_after=0)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [[], ["--mesh"], ["--no-kill"]])
def test_cli_chaos_subcommand(capsys, tmp_path, extra):
    argv = ["chaos", "--requests", "10", "--seed", "2", "--json", *extra]
    jax_rc = jax_main(argv)
    jax_rec = _last_json(capsys)
    rc = cli_main(argv + ["--device", "cpu", "--trace",
                          str(tmp_path / "t.jsonl")])
    rec = _last_json(capsys)
    assert rc == jax_rc == 0
    assert set(rec) == set(jax_rec)
    for key in COMPARED:
        assert rec[key] == jax_rec[key], key
    assert rec["ok"] is True
    assert rec["killed"] is (not extra == ["--no-kill"])
    assert sum(rec["counts"].values()) == 10
    assert obs_trace.validate_file(str(tmp_path / "t.jsonl")) == []


def test_cli_chaos_rejects_bad_args(capsys):
    assert cli_main(["chaos", "--device", "cpu", "--warm-start"]) == 2
    assert "Queue A item 13" in capsys.readouterr().err
    for argv in (["--grids", "10x10,"], ["--requests", "0"]):
        assert jax_main(["chaos", *argv]) == 2
        assert cli_main(["chaos", "--device", "cpu", *argv]) == 2
    if not torch.cuda.is_available():
        assert cli_main(["chaos", "--requests", "2"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
