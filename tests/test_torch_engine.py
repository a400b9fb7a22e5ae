"""The port's traces and scheduling engine against the reference's, plus
the port's import hygiene and device default.

Same config → same jobs; the same trace through
``repro_torch.runtime.SchedulingEngine(M, make_policy("wf_torch", o))``
and ``repro.runtime.SchedulingEngine(M, make_policy("wf_jax", o))`` →
the same schedule (``jct``, ``makespan``, ``failed_jobs``).
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.runtime as ref_runtime
import repro.traces as ref_traces
from repro_torch import backend, convert
from repro_torch.kernels import waterlevel as wl
from repro_torch.runtime import SchedulingEngine, make_policy
from repro_torch.traces import generate, list_scenarios

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

BURSTY = dict(n_jobs=40, total_tasks=4_000, n_servers=50, seed=1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with backend.set_backend(device="cpu"):
        yield
    torch.set_num_threads(threads)


def _job_fields(job):
    return (
        job.job_id,
        job.arrival,
        [(g.size, g.servers) for g in job.groups],
        np.asarray(job.mu).tolist(),
    )


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize(
    "scenario,overrides",
    [
        ("alibaba", dict(n_jobs=30, total_tasks=3_000, n_servers=40)),
        ("alibaba", dict(n_jobs=25, total_tasks=2_500, n_servers=20, zipf_alpha=1.6)),
        ("bursty", dict(n_jobs=30, total_tasks=3_000, n_servers=40)),
        ("bursty", dict(n_jobs=40, total_tasks=5_000, n_servers=64, mean_burst=9.0)),
        ("pareto_diurnal", dict(n_jobs=30, total_tasks=3_000, n_servers=40)),
        ("pareto_diurnal", dict(n_jobs=40, total_tasks=6_000, n_servers=64, pareto_alpha=1.2)),
    ],
)
def test_traces_identical_to_reference(scenario, overrides, seed):
    want = ref_traces.generate(scenario, seed=seed, **overrides)
    got = generate(scenario, seed=seed, **overrides)
    assert [_job_fields(j) for j in got] == [_job_fields(j) for j in want]
    assert [_job_fields(j) for j in convert.from_reference_jobs(want)] == [
        _job_fields(j) for j in want
    ]


def test_scenario_registry():
    assert list_scenarios() == ["alibaba", "bursty", "cluster_v2017", "pareto_diurnal"]
    assert list_scenarios() == ref_traces.list_scenarios()
    with pytest.raises(KeyError, match="unknown trace scenario"):
        generate("no_such_scenario")
    with pytest.raises(FileNotFoundError, match="ClusterTraceConfig.path"):
        generate("cluster_v2017")  # the CSV replay needs its path


def _same_schedule(got, want):
    assert got.jct == want.jct
    assert got.makespan == want.makespan
    assert got.failed_jobs == want.failed_jobs


@pytest.mark.parametrize("ordering", ["fifo", "ocwf-acc"])
def test_engine_wf_torch_matches_reference_wf_jax(ordering):
    ref_jobs = ref_traces.generate("bursty", **BURSTY)
    want = ref_runtime.SchedulingEngine(
        BURSTY["n_servers"], ref_runtime.make_policy("wf_jax", ordering)
    ).run(ref_jobs)
    jobs = convert.from_reference_jobs(ref_jobs)
    wl.reset_counts()
    got = SchedulingEngine(
        BURSTY["n_servers"],
        make_policy("wf_torch", ordering),
        debug=True,
        on_slot=lambda cluster, slot: cluster.assert_invariant(),
    ).run(jobs)
    _same_schedule(got, want)
    assert wl.COUNTS["plain"] > 0  # the device path ran (its CPU version here)
    assert len(got.overhead_s) == len(jobs)


@pytest.mark.parametrize("ordering", ["fifo", "ocwf", "ocwf-acc", "setf"])
def test_engine_batched_equals_per_arrival_and_host_wf(ordering):
    jobs = generate("bursty", n_jobs=24, total_tasks=3_000, n_servers=20, seed=7)
    assert len({j.arrival for j in jobs}) < len(jobs), "trace must contain bursts"
    batched = SchedulingEngine(20, make_policy("wf_torch", ordering)).run(jobs)
    per_arrival = SchedulingEngine(
        20, make_policy("wf_torch", ordering), batch_arrivals=False
    ).run(jobs)
    host = SchedulingEngine(20, make_policy("wf", ordering), debug=True).run(jobs)
    _same_schedule(batched, per_arrival)
    _same_schedule(batched, host)


def test_engine_wf_torch_torch_route_matches_host_wf():
    jobs = generate("alibaba", n_jobs=20, total_tasks=2_500, n_servers=20, seed=11)
    host = SchedulingEngine(20, "wf").run(jobs)
    with backend.set_backend(waterlevel="torch"):
        dev = SchedulingEngine(20, "wf_torch").run(jobs)
    _same_schedule(dev, host)


def test_make_policy_rejects_unknown_names():
    with pytest.raises(KeyError):
        make_policy("not-a-policy")
    with pytest.raises(ValueError):
        make_policy("wf", "not-an-ordering")
    assert make_policy("wf_torch").batch_assigner is not None
    assert make_policy("wf").batch_assigner is None


# ---- import hygiene -----------------------------------------------------------


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: p.relative_to(PORT).as_posix()
)
def test_port_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_isolation_checks_cover_the_rd_slice():
    """The RD slice's modules and kernel source are among the files the
    import checks above and below walk."""
    walked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"core/rd.py", "core/rd_torch.py", "kernels/rd.py"} <= walked
    assert (PORT / "kernels" / "csrc" / "rd_step.cu").is_file()


def test_isolation_checks_cover_the_control_plane_slice():
    """The exact-assignment, RD+ and control-plane slice's modules are
    among the files the import checks above and below walk."""
    walked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    expected = {
        "core/flow.py", "core/obta.py", "core/rd_reference.py", "core/rd_plus.py",
        "runtime/events.py", "obs/metrics.py", "runtime/resilience.py",
        "analysis/runtime.py", "placement/store.py", "placement/events.py",
        "placement/policies.py", "placement/__init__.py", "runtime/cluster.py",
        "runtime/engine.py", "runtime/loop.py", "traces/clients.py",
        "traces/placement.py", "traces/__init__.py", "traces/resilience.py",
        "traces/pareto.py", "runtime/simulator.py",
    }
    assert expected <= walked


def test_isolation_checks_cover_the_observability_slice():
    """The observability, contracts, CSV replay and MoE routing modules
    are among the files the import checks above and below walk."""
    walked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    expected = {
        "obs/__init__.py", "obs/clock.py", "obs/metrics.py", "obs/session.py",
        "obs/trace.py", "obs/report.py", "analysis/__init__.py",
        "analysis/contracts.py", "analysis/kernelcheck.py",
        "traces/cluster_v2017.py", "serve/moe_balance.py",
    }
    assert expected <= walked


def test_report_without_a_cpu_scope_does_not_run_on_the_cpu(tmp_path):
    """``python -m repro_torch.obs.report`` runs on the card unless given
    ``--device cpu``: with no GPU its default ``wf_torch`` run is refused
    at the first arrival, and ``--device cpu`` writes the artifacts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    code = (
        "from repro_torch.obs import report\n"
        f"out = {str(tmp_path)!r}\n"
        "try:\n"
        "    report.main(['--scenario', 'bursty', '--out', out])\n"
        "except (AssertionError, RuntimeError) as exc:\n"
        "    print('refused:', exc)\n"
        "else:\n"
        "    raise SystemExit('the report ran without a device')\n"
        "assert report.main(['--scenario', 'bursty', '--out', out, '--device', 'cpu']) == 0\n"
    )
    out = _run_port(code)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "refused:" in out.stdout
    assert (tmp_path / "OBS_bursty.trace.json").is_file()


def test_isolation_checks_cover_the_model_slice():
    """The dense model / serving slice's modules and kernel sources are
    among the files the import checks above and below walk."""
    walked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    expected = {
        "models/__init__.py", "models/config.py", "models/layers.py", "models/rope.py",
        "models/attention.py", "models/ffn.py", "models/model.py",
        "serve/__init__.py", "serve/engine.py",
        "kernels/rmsnorm.py", "kernels/decode_attention.py",
        "kernels/flash_attention.py", "kernels/ops.py",
        "configs/__init__.py", "configs/qwen1_5_4b.py", "configs/qwen3_32b.py",
        "configs/qwen2_5_32b.py", "configs/qwen2_72b.py",
        "launch/__init__.py", "launch/serve.py",
    }
    assert expected <= walked
    for name in ("rmsnorm", "decode_attention", "flash_attention"):
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").is_file()


def test_isolation_checks_cover_every_kernel_source():
    """Every CUDA source the builder compiles is a file under csrc/, among
    them the water-level kernels (K1/K2 and the fused water-filling kernel)
    and the SSD scan's two routes; no source is left unbuilt."""
    from repro_torch.kernels import _build

    csrc = PORT / "kernels" / "csrc"
    assert {"waterlevel", "ssd_scan"} <= set(_build.SOURCES)
    assert {p.stem for p in csrc.glob("*.cu")} == set(_build.SOURCES)


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_forbidden(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert not _forbidden(node.module or "")


def test_importing_every_port_module_loads_no_jax_or_repro():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(
            ".__init__"
        )
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = _run_port(code)
    assert out.returncode == 0, out.stderr


# ---- device default -----------------------------------------------------------


def _run_port(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_entry_point_without_a_cpu_scope_does_not_run_on_the_cpu():
    """With no ``set_backend(device="cpu")`` scope the entry points place
    their tensors on ``cuda``; without a GPU torch itself refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    code = (
        "import numpy as np\n"
        "from repro_torch import backend\n"
        "from repro_torch.core import AssignmentProblem, TaskGroup\n"
        "from repro_torch.core.wf_torch import water_filling_torch\n"
        "assert str(backend.device()) == 'cuda'\n"
        "p = AssignmentProblem(busy=np.zeros(4), mu=np.ones(4),\n"
        "                      groups=(TaskGroup(3, (0, 1)),))\n"
        "try:\n"
        "    water_filling_torch(p)\n"
        "except (AssertionError, RuntimeError) as exc:\n"
        "    print('refused:', exc)\n"
        "else:\n"
        "    raise SystemExit('ran without a device')\n"
        "with backend.set_backend(device='cpu'):\n"
        "    assert water_filling_torch(p).alloc == [{0: 2, 1: 1}]\n"
        "from repro_torch.core.rd_torch import replica_deletion_torch\n"
        "try:\n"
        "    replica_deletion_torch(p)\n"
        "except (AssertionError, RuntimeError) as exc:\n"
        "    print('rd refused:', exc)\n"
        "else:\n"
        "    raise SystemExit('rd ran without a device')\n"
        "with backend.set_backend(device='cpu'):\n"
        "    from repro_torch.core.rd import replica_deletion\n"
        "    assert replica_deletion_torch(p).alloc == replica_deletion(p).alloc\n"
    )
    out = _run_port(code)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "refused:" in out.stdout
    assert "rd refused:" in out.stdout


def test_control_plane_without_a_cpu_scope_does_not_run_on_the_cpu():
    """``ControlPlane(policy="wf_torch")`` (and ``rd_plus``, through
    ``rd_torch``) places its assignments on ``cuda`` unless scoped: with
    no GPU, torch refuses at the first arrival.  ``obta`` is a host
    algorithm: it runs with no scope and touches no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    code = (
        "import numpy as np\n"
        "from repro_torch import backend\n"
        "from repro_torch.core import Job, TaskGroup\n"
        "from repro_torch.runtime import ControlPlane, SchedulingEngine\n"
        "jobs = [Job(job_id=0, arrival=0, groups=(TaskGroup(6, (0, 1)),),\n"
        "            mu=np.full(4, 2))]\n"
        "for policy in ('wf_torch', 'rd_plus'):\n"
        "    plane = ControlPlane(4, policy=policy)\n"
        "    plane.submit_many(jobs)\n"
        "    try:\n"
        "        plane.drain()\n"
        "    except (AssertionError, RuntimeError) as exc:\n"
        "        print(policy, 'refused:', exc)\n"
        "    else:\n"
        "        raise SystemExit(policy + ' ran without a device')\n"
        "    with backend.set_backend(device='cpu'):\n"
        "        plane = ControlPlane(4, policy=policy)\n"
        "        plane.submit_many(jobs)\n"
        "        assert plane.drain().jct == {0: 2}\n"
        "plane = ControlPlane(4, policy='obta')\n"
        "plane.submit_many(jobs)\n"
        "assert plane.drain().jct == {0: 2}\n"
        "assert SchedulingEngine(4, 'obta', step_mode='event').run(jobs).jct == {0: 2}\n"
        "import sys\n"
        "assert 'repro_torch.core.rd_torch' in sys.modules\n"
    )
    out = _run_port(code)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "wf_torch refused:" in out.stdout
    assert "rd_plus refused:" in out.stdout


def test_model_entry_points_without_a_cpu_scope_do_not_run_on_the_cpu():
    """``init_params`` and ``ServeEngine`` place their tensors on ``cuda``
    unless scoped: with no GPU, torch refuses; CPU parameters taken out
    of their scope are refused too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    code = (
        "import torch\n"
        "from repro_torch import backend\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import init_params\n"
        "from repro_torch.serve.engine import ServeEngine\n"
        "cfg = get_smoke_config('qwen1.5-4b')\n"
        "for build in (lambda: init_params(torch.Generator(), cfg),\n"
        "              lambda: init_params(torch.Generator(device='cuda'), cfg)):\n"
        "    try:\n"
        "        build()\n"
        "    except (AssertionError, RuntimeError) as exc:\n"
        "        print('init refused:', exc)\n"
        "    else:\n"
        "        raise SystemExit('init_params ran without a device')\n"
        "with backend.set_backend(device='cpu'):\n"
        "    params = init_params(torch.Generator(), cfg)\n"
        "    ServeEngine(params, cfg, batch_slots=2, max_len=8)\n"
        "try:\n"
        "    ServeEngine(params, cfg, batch_slots=2, max_len=8)\n"
        "except ValueError as exc:\n"
        "    print('engine refused:', exc)\n"
        "else:\n"
        "    raise SystemExit('ServeEngine ran on the CPU without a scope')\n"
    )
    out = _run_port(code)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("init refused:") == 2
    assert "engine refused:" in out.stdout
