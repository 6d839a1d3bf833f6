"""CPU rehearsal of every phase of chip_smoke.py at tiny sizes, its refusal
to run without a GPU, and the compile-cache placement of the entry points.
The GPU run itself is ``test_chip_smoke_on_gpu`` (marker ``gpu``)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs
from cuda_bundle_adjustment_tpu.graph import GraphOptimisationOptions
from cuda_bundle_adjustment_tpu.io.synthetic import (
    city_scale_problem,
    make_ba_problem,
    make_mixed_ba_problem,
)
from cuda_bundle_adjustment_tpu.utils import runtime

REPO = Path(__file__).resolve().parents[1]
F32_HUBER = dict(options=GraphOptimisationOptions(dtype="float32"), rk=3,
                 delta=10.0)


def _tiny(kind="mono", seed=0):
    if kind == "mixed":
        return make_mixed_ba_problem(num_poses=10, num_landmarks=80, seed=seed)
    return make_ba_problem(num_poses=10, num_landmarks=80, kind=kind,
                           seed=seed)


def _child_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


# -- device check and the script's refusals -------------------------------------


def test_device_phase_refuses_a_cpu_backend():
    with pytest.raises(runtime.NoGpuError, match="needs a GPU"):
        cs.phase_device()


def test_script_fails_without_gpu_and_prints_no_result():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_script_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke run on the card, in a child process (this process
    stays on the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')


# -- compile cache placement ------------------------------------------------------


def test_compile_cache_defaults_to_a_gitignored_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = Path(runtime.compile_cache_dir())
    assert d == REPO / runtime.CACHE_DIRNAME
    ignored = (REPO / ".gitignore").read_text().split()
    assert f"{runtime.CACHE_DIRNAME}/" in ignored


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.compile_cache_dir() == str(tmp_path)
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_xla_gpu_flags_append_and_yield_to_given_ones(monkeypatch):
    monkeypatch.setenv(
        "XLA_FLAGS", "--foo=1 --xla_gpu_force_compilation_parallelism=2"
    )
    flags = runtime.set_xla_gpu_flags().split()
    assert flags[0] == "--foo=1"
    assert "--xla_gpu_force_compilation_parallelism=2" in flags
    assert "--xla_gpu_force_compilation_parallelism=16" not in flags
    assert "--xla_gpu_enable_llvm_module_compilation_parallelism=true" in flags
    # idempotent
    assert runtime.set_xla_gpu_flags().split() == flags


def test_test_suite_uses_the_checkout_cache():
    assert jax.config.jax_compilation_cache_dir == runtime.compile_cache_dir()


# -- phase functions at tiny sizes ---------------------------------------------


@pytest.mark.parametrize("kind, kwargs", [
    ("mono", {}), ("mixed", {}), ("mono", F32_HUBER),
], ids=["mono", "mixed", "huber_f32"])
def test_main_path_phase(kind, kwargs, capsys):
    r = cs.run_main_path(f"tiny_{kind}", _tiny(kind), kwargs, "CPU rehearsal",
                         with_chi0=True)
    assert r["trace"][-1] < r["chi0"]
    out = capsys.readouterr().out
    assert "memory_analysis" in out and "chi2 trace" in out


def test_main_path_phase_rejects_a_rising_trace(monkeypatch):
    real = cs._trace
    monkeypatch.setattr(cs, "_trace", lambda opt: real(opt)[::-1] + [1e30])
    with pytest.raises(cs.PhaseFailed):
        cs.run_main_path("tiny", _tiny(), {}, "CPU rehearsal")


def test_object_api_phase(capsys):
    cs.phase_object_api()
    assert "[object_api]" in capsys.readouterr().out


def test_profile_phase(capsys):
    cs.phase_profile(_tiny(), "CPU rehearsal", niters=3)
    out = capsys.readouterr().out
    assert out.count("[profile]   ") == 9


@pytest.mark.parametrize("kwargs, tol", [({}, cs.F64_TOL), (F32_HUBER, cs.F32_TOL)],
                         ids=["f64", "f32"])
def test_stage_parity_phase(kwargs, tol, capsys):
    # two CPU devices stand in for the card and the CPU backend
    d = jax.devices()
    cs.stage_parity("tiny", _tiny(), kwargs, tol, d[1], d[0])
    assert capsys.readouterr().out.count("max|gpu-cpu|") >= 10


def _round_mantissa(bits):
    """Round f32 values to ``bits`` explicit mantissa bits, to nearest."""
    import jax.numpy as jnp

    drop = 23 - bits
    keep = jnp.uint32(~((1 << drop) - 1) & 0xFFFFFFFF)

    def rounding(x):
        b = jax.lax.bitcast_convert_type(x, jnp.uint32)
        b = (b + jnp.uint32(1 << (drop - 1))) & keep
        return jax.lax.bitcast_convert_type(b, jnp.float32)

    return rounding


@pytest.mark.parametrize("bits", [10, 7], ids=["tf32", "bf16"])
def test_stage_parity_fails_terms_rounded_to_lower_precision(bits,
                                                             monkeypatch):
    """On the device standing in for the card, build_system's per-edge
    quadratic-form terms are rounded to TF32's or bf16's mantissa, as a
    lower-precision contraction would round them: the f32 gate must fail."""
    from cuda_bundle_adjustment_tpu.ops import components as C
    from cuda_bundle_adjustment_tpu.solver import block_solver as bs

    d = jax.devices()
    real, stacks = bs.build_system_jit, C.weighted_block_stacks
    rounding = _round_mantissa(bits)

    def rounded_stacks(*args):
        return tuple(None if x is None else rounding(x) for x in stacks(*args))

    def degraded(graph, packed, plan, metas, Pa, La):
        if graph.q.devices() != {d[1]}:
            return real(graph, packed, plan, metas, Pa, La)
        with monkeypatch.context() as m:
            m.setattr(C, "weighted_block_stacks", rounded_stacks)
            return bs.build_system(graph, packed, metas, Pa, La, plan)

    monkeypatch.setattr(bs, "build_system_jit", degraded)
    with pytest.raises(cs.PhaseFailed, match="build_system"):
        cs.stage_parity("tiny", _tiny(), F32_HUBER, cs.F32_TOL, d[1], d[0])


def test_trace_and_chi0_parity_phases():
    from cuda_bundle_adjustment_tpu.io.arrays import optimizer_from_problem

    p = _tiny(seed=3)
    opt = optimizer_from_problem(p)
    chi0 = cs._chi0(opt)
    opt.optimize(4)
    trace = cs._trace(opt)
    cpu = jax.devices()[2]
    cs.trace_parity("tiny", p, {}, trace, cpu, niters=4)
    cs.chi0_parity("tiny", p, {}, chi0, cpu)
    with pytest.raises(cs.PhaseFailed):
        cs.trace_parity("tiny", p, {}, [t * (1 + 1e-6) for t in trace], cpu,
                        niters=4)


def test_dense_oracle_phase(capsys):
    cs.dense_oracle_parity()
    assert "PARITY: OK" in capsys.readouterr().out


def test_four_phase_on_a_virtual_mesh(capsys):
    """--four's path on four virtual CPU devices against one."""
    p = city_scale_problem(seed=0, scale=0.002)
    cs.phase_four(p, jax.devices()[:4], niters=3)
    out = capsys.readouterr().out
    assert "4 cards vs 1" in out and np.isfinite(len(out))


def test_one_card_run_rehearsed_at_tiny_sizes(monkeypatch, capsys):
    """The whole one-card flow (main path, profile, parities, object API,
    dense oracle, determinism) with every configuration cut to a tiny
    graph."""
    import bench

    def tiny_problem(config):
        if config == "kitti00_mixed":
            return _tiny("mixed", seed=1), {}
        if config == "kitti00_huber_f32":
            return _tiny(seed=2), dict(F32_HUBER)
        return _tiny("stereo" if "stereo" in config else "mono",
                     seed=len(config)), {}

    monkeypatch.setattr(bench, "make_problem", tiny_problem)
    cs.run_one_card(jax.devices()[:1], "CPU rehearsal")
    out = capsys.readouterr().out
    for tag in ("[kitti00_mixed]", "[profile]", "[parity:kitti07_huber_f32]",
                "[object_api]", "[determinism]"):
        assert tag in out
    assert "PARITY: OK" in out
