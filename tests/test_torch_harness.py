"""The port's run report, command line, device policy and import rule.

- ``run_once`` and ``--json`` give the JAX ``RunReport.json_dict`` key set.
- Every entry point runs on ``cuda`` unless the caller asks for the CPU,
  and raises without a card; the check is made with the card hidden, so
  it holds on a machine that has one too.
- No module of the port, and not ``chip_smoke.py``, imports ``jax`` or
  the JAX package.
"""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.harness.run import run_once as jax_run_once
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.ops import assembly as jax_assembly
from poisson_ellipse_tpu.utils import error as jax_error
from poisson_ellipse_tpu_torch import interop
from poisson_ellipse_tpu_torch.harness import roofline
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.harness.run import run_once
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops import fused_pcg as fp
from poisson_ellipse_tpu_torch.solver import engine, pcg
from poisson_ellipse_tpu_torch.utils import device as device_mod
from poisson_ellipse_tpu_torch.utils import error

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "poisson_ellipse_tpu"}


@pytest.fixture(scope="module")
def jax_keys():
    report = jax_run_once(JaxProblem(M=10, N=10), mode="single", dtype="f32",
                          engine="xla")
    return set(report.json_dict())


@pytest.mark.parametrize("engine_name,dtype", [("xla", "f64"),
                                               ("pallas", "f32"),
                                               ("fused", "f32"),
                                               ("resident", "f32"),
                                               ("streamed", "f32"),
                                               ("xl", "f32")])
def test_run_once_report_has_the_jax_keys(jax_keys, engine_name, dtype):
    report = run_once(Problem(M=10, N=10), dtype=dtype, engine=engine_name,
                      repeat=2, device="cpu")
    d = report.json_dict()
    assert set(d) == jax_keys
    assert d["iters"] == 15 and d["converged"] is True
    assert d["engine"] == engine_name and d["mesh"] == [1, 1]
    # no device-memory rate for a run on the CPU
    assert d["hbm_gbps"] is None and d["hbm_peak_frac"] is None
    assert d["passes_per_iter"] == roofline.passes_per_iter(
        engine_name, Problem(M=10, N=10))
    assert len(report.times) == 2 and report.host_syncs >= 2
    assert "Converged after 15 iterations" in report.summary()


def test_cli_json_on_cpu(jax_keys, capsys):
    rc = cli_main(["--grids", "10x10,20x20", "--norm", "unweighted",
                   "--device", "cpu", "--json"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    records = [json.loads(ln) for ln in lines]
    assert [r["iters"] for r in records] == [17, 31]
    assert all(set(r) == jax_keys for r in records)
    # auto on the CPU: the capacity ladder's last rung, the xl plain version
    assert all(r["engine"] == "xl" for r in records)


def test_cli_exit_codes(capsys):
    assert cli_main(["--grids", "10by10", "--device", "cpu"]) == 2
    # delta = 1e-30 is never met: the loop ends on the breakdown guard
    assert cli_main(["10", "10", "--delta", "1e-30", "--engine", "xla",
                     "--dtype", "f64", "--device", "cpu"]) == 2
    assert "BREAKDOWN after 20 iterations" in capsys.readouterr().out


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, capsys):
    problem = Problem(M=10, N=10)
    for call in (
        lambda: engine.solve(problem),
        lambda: engine.build_solver(problem),
        lambda: pcg.solve(problem),
        lambda: fp.solve_fused(problem),
        lambda: run_once(problem),
        lambda: assembly.assemble(problem),
        lambda: device_mod.resolve_device(None),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert cli_main(["10", "10"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    # the explicit CPU request runs
    assert int(engine.solve(problem, device="cpu").iters) == 15


def test_run_once_ports_single_mode_only():
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        run_once(Problem(M=10, N=10), mode="sharded", device="cpu")


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.capacity("cpu")


def test_roofline_model():
    assert roofline.passes_per_iter("xla") == 13
    assert roofline.passes_per_iter("pallas") == 13
    assert roofline.passes_per_iter("fused") == 17
    assert roofline.passes_per_iter("resident") == 0
    with pytest.raises(ValueError):
        roofline.passes_per_iter("cuda")
    # a CPU run reports no device-memory rate
    r = roofline.roofline(Problem(M=400, N=600), "fused", 546, 0.5,
                          torch.float32, "cpu")
    assert r == {"passes_per_iter": 17.0, "hbm_gbps": None,
                 "hbm_peak_frac": None}
    assert roofline.memory_peak_bytes_per_s("cpu") is None


def test_error_measures_match_jax():
    jp, problem = JaxProblem(M=30, N=40), Problem(M=30, N=40)
    a, b, rhs = jax_assembly.assemble_numpy(jp)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(a.shape) * 0.01
    ta, tb, trhs = interop.operands_from_reference(problem, a, b, rhs,
                                                   device="cpu")
    tw = torch.from_numpy(w)
    np.testing.assert_allclose(
        float(error.l2_error_vs_analytic(problem, tw)),
        float(jax_error.l2_error_vs_analytic(jp, jnp.asarray(w))),
        rtol=1e-13)
    np.testing.assert_allclose(
        float(error.residual_norm(problem, tw, ta, tb, trhs)),
        float(jax_error.residual_norm(jp, jnp.asarray(w), jnp.asarray(a),
                                      jnp.asarray(b), jnp.asarray(rhs))),
        rtol=1e-13)


def _port_files():
    files = sorted((ROOT / "poisson_ellipse_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = {f"{p.relative_to(ROOT)}: {root}" for p in files
           for root in _imported_roots(p) if root in FORBIDDEN}
    assert not bad, sorted(bad)


def test_import_scan_matches_whole_module_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import poisson_ellipse_tpu_torch.ops\n"
                   "from poisson_ellipse_tpu_torch import interop\n"
                   "import jax.numpy as jnp\n"
                   "from poisson_ellipse_tpu.ops import stencil\n")
    roots = list(_imported_roots(src))
    assert [r for r in roots if r in FORBIDDEN] == ["jax",
                                                    "poisson_ellipse_tpu"]
