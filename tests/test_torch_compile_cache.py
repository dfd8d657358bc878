"""The port's warm pool and bucketing (``poisson_ellipse_tpu_torch.runtime``)
against the JAX package's ``runtime.compile_cache``, on the CPU.

Tolerances:

- the bucket ladder, lane buckets, affinity keys and pool keys: equal;
- hit/miss counts and entry identity: the JAX package's, call for call;
- ``WarmPool.solve`` against JAX's at 10x10 (bucket 12x12): equal
  iterations and flags per lane, w within 1e-10 at f64 and within 1e-5 of
  its scale at f32;
- the pool's chunked replay against the eager ``init_state`` + ``advance``
  on the same buffers: bitwise (on the CPU the chunk runs eagerly; the
  card's graph replay is held in ``tests/test_torch_gpu.py``).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_ellipse_tpu.harness.__main__ import main as jax_main
from poisson_ellipse_tpu.models.problem import Problem as JaxProblem
from poisson_ellipse_tpu.obs import trace as jax_trace
from poisson_ellipse_tpu.runtime import compile_cache as jcc
from poisson_ellipse_tpu_torch.harness.__main__ import main as cli_main
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import metrics as obs_metrics
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.runtime import compile_cache as cc

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
ENGINES = ("batched", "batched-pipelined")
W_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


@pytest.fixture(autouse=True)
def one_torch_thread_and_no_tracer():
    """One PyTorch thread a test, no ambient tracer in either package, and
    the kernel library directory restored after a test that moves it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (obs_trace, jax_trace):
        mod.stop()
        mod._env_checked = True
    build_dir, persistent = _build.BUILD_DIR, cc._persistent_dir
    yield
    _build.BUILD_DIR, cc._persistent_dir = build_dir, persistent
    obs_trace.stop()
    jax_trace.stop()
    torch.set_num_threads(before)


def test_ladder_equals_jax():
    assert list(cc._ladder()) == list(jcc._ladder())


@pytest.mark.parametrize("lo,hi", [(2, 1000), (1000, 5001)])
def test_bucket_dim_and_lane_bucket_equal_jax(lo, hi):
    for n in range(lo, hi):
        assert cc.bucket_dim(n) == jcc.bucket_dim(n)
        assert cc.lane_bucket(n) == jcc.lane_bucket(n)


def test_bucket_errors_equal_jax():
    for fn in ("bucket_dim", "lane_bucket"):
        for bad in (0, 1) if fn == "bucket_dim" else (0, -3):
            with pytest.raises(ValueError) as port_err:
                getattr(cc, fn)(bad)
            with pytest.raises(ValueError) as jax_err:
                getattr(jcc, fn)(bad)
            assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as port_err:
        cc.bucket_dim((3 << 19) + 1)
    with pytest.raises(ValueError) as jax_err:
        jcc.bucket_dim((3 << 19) + 1)
    assert str(port_err.value) == str(jax_err.value)


def test_grid_bucket_and_affinity_key_equal_jax():
    rng = np.random.default_rng(0)
    for M, N in rng.integers(2, 5000, size=(200, 2)).tolist() + [
            [400, 600], [800, 1200], [10, 10], [12, 12]]:
        assert cc.grid_bucket(M, N) == jcc.grid_bucket(M, N)
        for norm in ("weighted", "unweighted"):
            assert (cc.warm_affinity_key(M, N, norm)
                    == jcc.warm_affinity_key(M, N, norm))
    assert cc.grid_bucket(400, 600) == (512, 768)
    assert cc.grid_bucket(800, 1200) == (1024, 1536)


@pytest.mark.parametrize("storage", [None, "bf16", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pool_key_equals_jax(dtype, storage):
    for engine in ENGINES:
        for grid, lanes in (((10, 10), 3), ((400, 600), 8), ((9, 40), 1)):
            assert cc.WarmPool.key(engine, grid, dtype, lanes,
                                   storage_dtype=storage) == \
                jcc.WarmPool.key(engine, grid, JAX_DTYPE[dtype], lanes,
                                 storage_dtype=storage)


def test_rerequest_is_a_hit_same_entry_as_jax():
    """JAX tests/test_batched.py's hit/miss sequence: the counts after each
    call and the identities are the JAX pool's."""
    pool, jpool = cc.WarmPool(), jcc.WarmPool()
    seq = [((10, 10), 3), ((11, 12), 4), ((10, 10), 5), ((12, 12), 8)]
    entries, jentries = [], []
    for grid, lanes in seq:
        entries.append(pool.warmup("batched", grid, torch.float32,
                                   lanes=lanes, device="cpu"))
        jentries.append(jpool.warmup("batched", grid, jnp.float32,
                                     lanes=lanes))
        assert (pool.hits, pool.misses) == (jpool.hits, jpool.misses)
    # a different request shape in the same bucket: the same entry and the
    # same buffers and chunk; a different lane bucket is another entry
    assert entries[1] is entries[0] and jentries[1] is jentries[0]
    assert entries[1].compiled is entries[0].compiled
    assert entries[2].compiled is not entries[0].compiled
    assert entries[3] is entries[2]
    for e, je in zip(entries, jentries):
        assert (e.engine, e.bucket, e.lanes, e.dtype, e.norm, e.storage) == \
            (je.engine, je.bucket, je.lanes, je.dtype, je.norm, je.storage)
    assert entries[0].device == "cpu"
    assert entries[0].compiled.graphs == {}  # the CPU runs the chunk eagerly


def test_warmup_auto_resolves_to_batched_and_rejects_others():
    pool, jpool = cc.WarmPool(), jcc.WarmPool()
    assert pool.warmup("auto", (10, 10), device="cpu").engine == "batched"
    assert jpool.warmup("auto", (10, 10)).engine == "batched"
    with pytest.raises(ValueError) as port_err:
        pool.warmup("xla", (10, 10), device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jpool.warmup("xla", (10, 10))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as port_err:
        pool.warmup("batched-pipelined", (10, 10), storage_dtype="bf16",
                    device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jpool.warmup("batched-pipelined", (10, 10), storage_dtype="bf16")
    assert str(port_err.value) == str(jax_err.value)


def test_pool_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cc.WarmPool().warmup("batched", (10, 10))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("engine", ENGINES)
def test_solve_matches_jax(engine, dtype):
    p, jp = Problem(M=10, N=10), JaxProblem(M=10, N=10)
    res = cc.WarmPool().solve(p, 3, engine, dtype, device="cpu")
    jres = jcc.WarmPool().solve(jp, 3, engine, JAX_DTYPE[dtype])
    assert res.w.shape == (3, 11, 11) and res.w.dtype == dtype
    assert res.iters.tolist() == np.asarray(jres.iters).tolist()
    for name in ("converged", "breakdown", "quarantined"):
        assert getattr(res, name).tolist() == \
            np.asarray(getattr(jres, name)).tolist()
    want = np.asarray(jres.w, np.float64)
    scale = np.abs(want).max() if dtype == torch.float32 else 1.0
    assert np.abs(res.w.double().numpy() - want).max() <= W_TOL[dtype] * scale


def test_solve_with_rhs_stack_matches_jax():
    p, jp = Problem(M=10, N=10), JaxProblem(M=10, N=10)
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((2, 11, 11))
    rhs[:, 0] = rhs[:, -1] = rhs[:, :, 0] = rhs[:, :, -1] = 0.0
    res = cc.WarmPool().solve(p, 2, "batched", torch.float64, rhs=rhs,
                              device="cpu")
    jres = jcc.WarmPool().solve(jp, 2, "batched", jnp.float64, rhs=rhs)
    assert res.iters.tolist() == np.asarray(jres.iters).tolist()
    np.testing.assert_allclose(res.w.numpy(), np.asarray(jres.w), rtol=0,
                               atol=1e-10)
    with pytest.raises(ValueError) as port_err:
        cc.WarmPool().solve(p, 3, "batched", torch.float64, rhs=rhs,
                            device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jcc.WarmPool().solve(jp, 3, "batched", jnp.float64, rhs=rhs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("engine", ENGINES)
def test_chunked_replay_bitwise_the_eager_advance(engine):
    """The pool's chunk loop (64 bodies a chunk, the flags read once a
    chunk) against ``init_state`` + ``advance`` on the same buffers; a
    second solve through the same entry reproduces the first."""
    from poisson_ellipse_tpu_torch.batch import (
        batched_pcg,
        batched_pipelined,
    )

    mod = batched_pcg if engine == "batched" else batched_pipelined
    pool = cc.WarmPool()
    p = Problem(M=80, N=60)
    res = pool.solve(p, 3, engine, torch.float32, device="cpu")
    g = pool.warmup(engine, (80, 60), torch.float32, 3,
                    device="cpu").compiled
    assert res.iters.tolist()[0] > g.chunk  # more than one chunk ran
    state = mod.init_state(g.proto, g.a, g.b, g.rhs, mask=g.mask, h1=g.h1,
                           h2=g.h2)
    state, _ = mod.advance(g.proto, g.a, g.b, g.rhs, state,
                           limit=p.max_iterations, mask=g.mask, h1=g.h1,
                           h2=g.h2, delta=g.delta, chunk=g.chunk)
    want = mod.result_of(state)
    assert torch.equal(res.w, want.w[:3, :81, :61])
    assert torch.equal(res.iters, want.iters[:3])
    assert torch.equal(res.diff, want.diff[:3])
    again = pool.solve(p, 3, engine, torch.float32, device="cpu")
    assert torch.equal(again.w, res.w) and pool.hits == 2


def test_solve_storage_bf16_runs_narrow():
    pool = cc.WarmPool()
    entry = pool.warmup("batched", (10, 10), torch.float32, 2,
                        storage_dtype="bf16", device="cpu")
    assert entry.storage == "bfloat16"
    assert entry.compiled.state.w.dtype == torch.bfloat16
    assert entry is not pool.warmup("batched", (10, 10), torch.float32, 2,
                                    device="cpu")


def test_cache_events_and_counters_emitted(tmp_path):
    path = tmp_path / "cache.jsonl"
    obs_metrics.REGISTRY.reset()
    pool = cc.WarmPool()
    obs_trace.start(str(path))
    try:
        pool.warmup("batched", (10, 10), torch.float32, lanes=1,
                    device="cpu")
        pool.warmup("batched", (10, 10), torch.float32, lanes=1,
                    device="cpu")
    finally:
        obs_trace.stop()
    assert obs_trace.validate_file(str(path)) == []
    recs = [r for r in obs_trace.read_jsonl(str(path))
            if r["name"].startswith("cache:")]
    assert [r["name"] for r in recs] == ["cache:miss", "cache:hit"]
    assert recs[0]["fields"]["bucket"] == [12, 12]
    assert set(recs[0]["fields"]) == {"engine", "bucket", "lanes", "dtype",
                                      "compile_s"}
    assert set(recs[1]["fields"]) == {"engine", "bucket", "lanes", "dtype"}
    snap = obs_metrics.REGISTRY.snapshot()["counters"]
    assert snap["compile_cache_hits"] == 1
    assert snap["compile_cache_misses"] == 1
    obs_metrics.REGISTRY.reset()


def test_enable_persistent_cache_points_the_build_directory(tmp_path,
                                                            monkeypatch):
    default = str(_build.BUILD_DIR)
    monkeypatch.delenv(cc.ENV_CACHE_DIR, raising=False)
    assert cc.enable_persistent_cache(device="cpu") == default
    env_dir = tmp_path / "env"
    monkeypatch.setenv(cc.ENV_CACHE_DIR, str(env_dir))
    trace = tmp_path / "t.jsonl"
    obs_trace.start(str(trace))
    try:
        got = cc.enable_persistent_cache(device="cpu")
    finally:
        obs_trace.stop()
    assert got == str(env_dir) and env_dir.is_dir()
    assert str(_build.BUILD_DIR) == str(env_dir)
    assert _build.library_path("stencil").parent == env_dir
    recs = obs_trace.read_jsonl(str(trace))
    assert [r["fields"]["dir"] for r in recs
            if r["name"] == "cache:persistent-enabled"] == [str(env_dir)]
    chosen = tmp_path / "chosen"
    assert cc.enable_persistent_cache(str(chosen), device="cpu") == \
        str(chosen)
    # idempotent
    assert cc.enable_persistent_cache(str(chosen), device="cpu") == \
        str(chosen)


def test_warm_pool_is_process_wide():
    assert cc.warm_pool() is cc.warm_pool()
    assert isinstance(cc.warm_pool(), cc.WarmPool)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_warmup_matches_jax(capsys, tmp_path):
    argv = ["warmup", "--grids", "10x10,20", "--lanes", "1,3",
            "--engine", "both", "--no-persistent", "--json"]
    jax_rc = jax_main(argv)
    jax_rec = _last_json(capsys)
    cc._POOL = None
    rc = cli_main(argv + ["--device", "cpu"])
    rec = _last_json(capsys)
    assert rc == jax_rc == 0
    assert set(rec) == set(jax_rec)
    strip = [{k: v for k, v in row.items() if k != "compile_s"}
             for row in rec["warmed"]]
    jstrip = [{k: v for k, v in row.items() if k != "compile_s"}
              for row in jax_rec["warmed"]]
    assert strip == jstrip
    assert rec["persistent_dir"] is None
    # a second call in the process: every bucket is a hit
    rc = cli_main(argv + ["--device", "cpu"])
    again = _last_json(capsys)
    assert rc == 0 and again["hits"] == len(rows := again["warmed"])
    assert again["misses"] == rec["misses"] == len(rows)
    cache = tmp_path / "cache"
    assert cli_main(["warmup", "--grids", "10x10", "--lanes", "1",
                     "--cache-dir", str(cache), "--json", "--device",
                     "cpu"]) == 0
    assert _last_json(capsys)["persistent_dir"] == str(cache)
    assert os.path.isdir(cache)


def test_cli_warmup_rejects_bad_args(capsys):
    for argv in (["--grids", "10x10,"], ["--lanes", "x"]):
        assert cli_main(["warmup", "--device", "cpu", "--no-persistent",
                         *argv]) == 2
        assert jax_main(["warmup", "--no-persistent", *argv]) == 2
    if not torch.cuda.is_available():
        assert cli_main(["warmup", "--no-persistent"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
