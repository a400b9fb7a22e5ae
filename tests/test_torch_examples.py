"""The port's example scripts (``examples_torch/*.py``) against the
reference's (``examples/*.py``), on the CPU.

Each reference example runs in process through ``runpy.run_path`` under a
patched ``sys.argv``, its standard output captured; each port example's
``main`` runs with ``--device cpu`` (the kernels' plain versions):

- quickstart and fault tolerance print the reference's lines exactly;
- the serving example prints them exactly with the reference's weights
  (``PRNGKey(0)``, carried over by ``from_reference_params``) and expert
  placement passed in;
- the training example, from the reference's initial weights, runs 26
  steps failing a data host at step 13, then is called again to 51 steps
  with ``--compress``, resuming from the first call's checkpoint: the
  printed losses within 1e-4 (one unit of their last printed digit) at
  every printed step, the learning rates equal, the same resume step,
  the same checkpoints, and the compressed-grad solution equal at two
  decimals.  The reference's compression demo runs with its compressed
  gradient function jitted: eager ``shard_map`` traces it anew on each
  of its 200 calls (minutes on the CPU), jitted it prints the same
  solution in under a second.  Without ``--ckpt-dir`` the port keeps its
  checkpoints in a folder of its own; its compression demo leaves a
  process group that is up as it found it.

The scripts import neither ``jax`` nor anything of ``repro`` (AST and
``sys.modules``), and with ``--device cuda`` on a machine without a card
each exits non-zero with torch's error before printing anything.
``traces.available_scenarios()`` equals the reference's with the
reference's trace environment variable unset.
"""

import ast
import contextlib
import dataclasses
import io
import json
import runpy
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.train.compress as ref_compress
import repro.traces as ref_traces
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import init_params as ref_init_params
from repro.serve.moe_balance import replica_placement as ref_replica_placement
from repro.traces.cluster_v2017 import ENV_VAR
from repro_torch import traces
from repro_torch.backend import set_backend
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference_params
from repro_torch.core import wf_torch
from repro_torch.kernels import rd as rdk
from repro_torch.kernels import waterlevel as wl

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "examples"
PORT = ROOT / "examples_torch"
NAMES = ("quickstart", "fault_tolerance", "serve_moe_balanced", "train_locality")

# the training example's short runs: 26 steps (a data host failed at 13),
# then resumed to 51 with the compression demo
TRAIN_FLAGS = ["--seq-len", "32", "--batch", "2"]
FIRST = [*TRAIN_FLAGS, "--steps", "26", "--fail-host", "3"]
SECOND = [*TRAIN_FLAGS, "--steps", "51", "--compress"]


def _reference(name: str, argv: list[str], monkeypatch) -> str:
    """The reference example's standard output, run as ``__main__``."""
    path = str(REFERENCE / f"{name}.py")
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", [path, *argv])
    with contextlib.redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    return out.getvalue()


def _port(name: str, argv: list[str], **inject) -> str:
    """The port example's standard output, its ``main`` run on the CPU."""
    out = io.StringIO()
    main = runpy.run_path(str(PORT / f"{name}.py"))["main"]
    with contextlib.redirect_stdout(out):
        main([*argv, "--device", "cpu"], **inject)
    return out.getvalue()


def _reset_counts() -> None:
    wl.reset_counts()
    rdk.reset_counts()
    wf_torch.CALLS["adapter"] = 0


# ---- the scheduler examples ---------------------------------------------------


@pytest.mark.parametrize("name", ["quickstart", "fault_tolerance"])
def test_scheduler_example_prints_the_references_lines(name, monkeypatch):
    want = _reference(name, [], monkeypatch)
    _reset_counts()
    got = _port(name, [])
    assert got.splitlines() == want.splitlines()
    # WF went through wf_torch's adapter (its plain loop on the CPU), RD
    # through the step kernel's plain iteration
    assert wf_torch.CALLS["adapter"] > 0 and wl.COUNTS["plain"] > 0
    assert (rdk.COUNTS["plain"] > 0) == (name == "quickstart")


def test_serving_example_prints_the_references_lines(monkeypatch):
    want = _reference("serve_moe_balanced", [], monkeypatch)
    tree = ref_init_params(jax.random.PRNGKey(0), ref_smoke_config("qwen1.5-4b"))
    with set_backend(device="cpu"):
        params = from_reference_params(jax.tree.map(np.asarray, tree),
                                       get_smoke_config("qwen1.5-4b"))
    placement = np.asarray(ref_replica_placement(32, 16, 4))
    # experts share first replicas: the naive queue must add them all up
    assert len(set(placement[:, 0])) < len(placement)
    _reset_counts()
    got = _port("serve_moe_balanced", [], params=params, placement=placement)
    assert got.splitlines() == want.splitlines()
    assert wf_torch.CALLS["adapter"] == 6  # one a routed batch


# ---- the training example -----------------------------------------------------


def _jitted(make):
    def wrapped(grad_fn, mesh, axis="data"):
        return jax.jit(make(grad_fn, mesh, axis))

    return wrapped


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    """Both examples' two calls: {side: (first output, second output,
    checkpoint dir)}."""
    cfg = runpy.run_path(str(PORT / "train_locality.py"))["model_config"]("mamba2-130m")
    # the reference example's initial weights (its train_state_init's),
    # at its reduced width
    ref_cfg = ref_get_config("mamba2-130m").scaled(d_model=256, n_layers=4, vocab=8192,
                                                    dtype="float32")
    ref_cfg = dataclasses.replace(
        ref_cfg, ssm=dataclasses.replace(ref_cfg.ssm, state_dim=32, chunk=64))
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), ref_cfg))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_compress, "make_compressed_grad_fn",
                   _jitted(ref_compress.make_compressed_grad_fn))
        ckpt = tmp_path_factory.mktemp("reference")
        flags = ["--ckpt-dir", str(ckpt)]
        runs["reference"] = (_reference("train_locality", [*FIRST, *flags], mp),
                             _reference("train_locality", [*SECOND, *flags], mp), ckpt)
    ckpt = tmp_path_factory.mktemp("port")
    flags = ["--ckpt-dir", str(ckpt)]
    outs = []
    for argv in (FIRST, SECOND):
        with set_backend(device="cpu"):
            params = from_reference_params(tree, cfg)
        outs.append(_port("train_locality", [*argv, *flags], params=params))
    runs["port"] = (*outs, ckpt)
    return runs


def _step_lines(out: str) -> list[tuple[int, int, int, str]]:
    """(step, loss, grad norm in units of the printed last digit, lr) of
    every printed step."""
    rows = []
    for line in out.splitlines():
        if line.startswith("step "):
            step, loss, gnorm, lr = line.split()[1:]
            rows.append((int(step), round(float(loss.split("=")[1]) * 1e4),
                         round(float(gnorm.split("=")[1]) * 1e3), lr.split("=")[1]))
    return rows


@pytest.mark.parametrize("call", [0, 1], ids=["first", "resumed"])
def test_training_example_prints_the_references_losses(training, call):
    got, want = (_step_lines(training[side][call]) for side in ("port", "reference"))
    assert [r[0] for r in got] == [r[0] for r in want] == ([0, 25] if call == 0 else [50])
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) <= 1, (g, w)  # the loss within 1e-4
        assert abs(g[2] - w[2]) <= 2, (g, w)  # the gradient norm within 2e-3
        assert g[3] == w[3]  # the learning rate


def _other_lines(out: str, ckpt) -> list[str]:
    return [line.replace(str(ckpt), "CKPT") for line in out.splitlines()
            if not line.startswith("step ")]


@pytest.mark.parametrize("call", [0, 1], ids=["first", "resumed"])
def test_training_example_fails_the_host_resumes_and_saves_as_the_reference(training, call):
    got = _other_lines(training["port"][call], training["port"][2])
    want = _other_lines(training["reference"][call], training["reference"][2])
    # the compressed-grad solution is held below, at two decimals
    assert got[:-1] == want[:-1] if call else got == want
    if call == 0:
        assert got == ["!! failing data host 3", "done at step 26; checkpoints in CKPT"]
    else:
        assert got[:2] == ["resumed from step 26", "done at step 51; checkpoints in CKPT"]
    names = [sorted(p.name for p in training[side][2].iterdir())
             for side in ("port", "reference")]
    assert names[0] == names[1] == ["step_00000050", "step_00000051"]


def test_compressed_grad_solution_equals_the_references(training):
    def solution(out: str) -> list[float]:
        line = out.splitlines()[-1]
        assert line.startswith("compressed-grad solution ≈")
        return [float(x) for x in line.split("[")[1].rstrip("]").split()]

    got, want = (solution(training[side][1]) for side in ("port", "reference"))
    assert got == want
    np.testing.assert_allclose(got, np.arange(8), atol=0.25)  # near the target


def test_training_example_keeps_its_own_default_checkpoint_folder(tmp_path, monkeypatch):
    """Without ``--ckpt-dir`` (and with its own seeded weights) the port
    writes under ``repro_torch_ckpt/<arch>`` in the temporary directory,
    never into the reference example's ``/tmp/repro_ckpt``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _port("train_locality", ["--steps", "1", "--seq-len", "8", "--batch", "2"])
    folder = tmp_path / "repro_torch_ckpt" / "mamba2-130m"
    assert out.splitlines()[-1] == f"done at step 1; checkpoints in {folder}"
    assert [p.name for p in folder.iterdir()] == ["step_00000001"]


def test_compression_demo_keeps_a_process_group_that_is_up(tmp_path):
    """The demo makes its world of one rank only when no group is up, and
    leaves an initialised one as it found it."""
    demo = runpy.run_path(str(PORT / "train_locality.py"))["compression_demo"]
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        out = io.StringIO()
        with set_backend(device="cpu"), contextlib.redirect_stdout(out):
            demo()
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert out.getvalue().startswith("compressed-grad solution ≈ [-0.06  0.78")


# ---- import hygiene, the card's absence, scenarios ----------------------------


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_repro(name):
    path = PORT / f"{name}.py"
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(map(_forbidden, names)), f"{name}.py:{node.lineno} imports {names}"


RUN_AS_MAIN = (
    "import json, runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = [path]\n"
    "try:\n"
    "    runpy.run_path(path, run_name='__main__')\n"
    "finally:\n"
    "    print(json.dumps(sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
    "                            or m.startswith(('jax.', 'repro.')))))\n"
)


@pytest.mark.parametrize("name", NAMES)
def test_example_without_a_card_fails_before_printing_and_loads_no_jax(name):
    """Run as a program with no flags (``--device cuda``): torch's error,
    a non-zero exit, no line of the example's, and neither ``jax`` nor
    ``repro`` among the loaded modules."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    out = subprocess.run(
        [sys.executable, "-c", RUN_AS_MAIN, str(PORT / f"{name}.py")],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr.strip().splitlines()[-1], out.stderr[-2000:]
    assert json.loads(out.stdout) == []  # the module list is all it printed


def test_available_scenarios_equal_the_references(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    assert traces.available_scenarios() == ref_traces.available_scenarios()
    assert "cluster_v2017" not in traces.available_scenarios()
    assert traces.available_scenarios() == [
        s for s in traces.list_scenarios() if traces.scenario_available(s)]
