"""kernelcheck of the port (``repro_torch.analysis.kernelcheck``), as
``tests/test_kernelcheck.py`` holds the reference's: the registry, the
lattice, the interval math, the repo gate over the eight contracts of
the CUDA kernels' wrappers and adapters, and four violation fixtures —
written into ``tmp_path`` here — that must each fail with exactly their
check.  Then the port's own facts: the verdict per contract equals the
reference's, the contracts' shared memory is the launchers' formula,
and the constants the contracts rest on equal the reference's envelope
and the CUDA sources' ceilings.
"""

import json
import pathlib
import re
import textwrap

import pytest

from repro_torch.analysis.contracts import (
    CONTRACTS,
    Axis,
    BlockConfig,
    Interval,
    KernelContract,
    RangeClaim,
    lattice,
    register,
    span,
)
from repro_torch.analysis.kernelcheck import (
    DEFAULT_BUDGET_BYTES,
    DEFAULT_MODULES,
    DEFAULT_REPORT,
    main,
)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"

PORT_OF = {
    "waterlevel.kernel": "waterlevel.kernel",
    "waterlevel.kernel-batch": "waterlevel.kernel-batch",
    "rd.strip": "rd.step",
    "wf_jax.groups": "wf_torch.groups",
    "wf_jax.batch": "wf_torch.batch",
    "wf_jax.chain": "wf_torch.chain",
    "rd_jax.device": "rd_torch.device",
    "rd_jax.chain": "rd_torch.chain",
}


# ---- interval arithmetic ----------------------------------------------------


def test_interval_arithmetic_is_conservative():
    a = Interval(2, 5)
    b = Interval(-3, 4)
    assert a + b == Interval(-1, 9)
    assert a - b == Interval(-2, 8)
    assert a * b == Interval(-15, 20)
    assert -a == Interval(-5, -2)
    assert a + 1 == Interval(3, 6)
    assert Interval(0, 3) << 15 == Interval(0, 3 << 15)
    with pytest.raises(ValueError):
        Interval(3, 1)
    with pytest.raises(ValueError, match="negative"):
        _ = b << 2


def test_interval_or_is_a_packing_bound():
    hi = Interval(0, (1 << 15) - 1) << 15
    lo = Interval(0, (1 << 15) - 1)
    packed = hi | lo
    assert packed.hi < (1 << 30)
    assert packed.lo == 0
    with pytest.raises(ValueError):
        _ = Interval(-1, 0) | Interval(0, 1)


def test_range_claim_checks():
    ok = RangeClaim("fits", Interval(0, 100))
    assert ok.check() is None
    assert "int32" in RangeClaim("over", Interval(0, 1 << 40)).check()
    assert "15-bit" in RangeClaim("wide", Interval(0, 1 << 15), bits=15).check()
    assert "bound" in RangeClaim("env", Interval(0, 11), bound=10).check()
    assert "positive" in RangeClaim("head", Interval(0, 5), positive=True).check()
    assert RangeClaim("hash", Interval(0, 1 << 57), dtype="int64").check() is None


def test_block_config_sums_static_and_dynamic():
    cfg = BlockConfig(static_smem=800, dynamic_smem=3200, threads=64)
    assert cfg.smem_bytes == 4000


# ---- registry + lattice -----------------------------------------------------


def _dummy_contract(name, entry="tests.dummy.fn"):
    return KernelContract(
        name=name,
        entry=entry,
        module="tests.dummy",
        axes=(Axis("m", (1, 2)),),
        backends=("cuda",),
        device_backends=("cuda",),
        dispatch=lambda geom: "cuda",
    )


def test_register_is_idempotent_but_rejects_name_collisions():
    register(_dummy_contract("test.dummy"))
    try:
        register(_dummy_contract("test.dummy"))
        with pytest.raises(ValueError, match="already registered"):
            register(_dummy_contract("test.dummy", entry="tests.other.fn"))
    finally:
        del CONTRACTS["test.dummy"]


def test_span_is_boundary_focused():
    ax = span("m", 1, 100, boundaries=(32,), past=(101, 200))
    assert ax.points == (1, 31, 32, 33, 100)
    assert ax.past == (101, 200)
    assert span("m", 1, 10, boundaries=(10,)).points == (1, 9, 10)


def test_lattice_marks_past_points_inadmissible():
    c = KernelContract(
        name="test.lattice",
        entry="tests.dummy.fn",
        module="tests.dummy",
        axes=(Axis("m", (1, 2), past=(3,)), Axis("b", (10,))),
        backends=("cuda",),
        device_backends=("cuda",),
        dispatch=lambda geom: "cuda",
    )
    pts = list(lattice(c))
    assert ({"m": 1, "b": 10}, True) in pts
    assert ({"m": 2, "b": 10}, True) in pts
    assert ({"m": 3, "b": 10}, False) in pts
    assert len(pts) == 3


# ---- the repo gate ----------------------------------------------------------


def test_defaults_are_the_cards_and_keep_the_reference_report():
    assert DEFAULT_BUDGET_BYTES == 232_448  # an H100 block's opt-in shared memory
    assert DEFAULT_REPORT.endswith("KERNELCHECK_TORCH.json")
    assert not any(m.startswith("repro.") for m in DEFAULT_MODULES)


def _run_gate(tmp_path):
    report_path = tmp_path / "KERNELCHECK_TORCH.json"
    rc = main(["--report", str(report_path), "--max-eval", "1"])
    return rc, json.loads(report_path.read_text())


def test_repo_contracts_all_verify(tmp_path):
    rc, report = _run_gate(tmp_path)
    assert rc == 0
    names = {entry["contract"] for entry in report["contracts"]}
    assert set(PORT_OF.values()) <= names
    assert report["total_violations"] == 0
    assert report["budget_bytes"] == DEFAULT_BUDGET_BYTES
    for entry in report["contracts"]:
        assert entry["lattice_points"] > 0
        assert "violated" not in entry["checks"].values()
        assert entry["checks"]["memory"] == "ok"
        assert entry["abstract_evals"] >= 1
        assert sum(entry["backends"].values()) == entry["lattice_points"]
        assert 0 < entry["peak_smem_bytes"] <= DEFAULT_BUDGET_BYTES


def test_verdict_per_contract_equals_the_reference(tmp_path):
    """The reference's kernelcheck over its eight contracts and the
    port's over their counterparts: the same checks run, and the same
    verdict for each."""
    from repro.analysis.kernelcheck import main as ref_main

    ref_path = tmp_path / "KERNELCHECK.json"
    assert ref_main(["--report", str(ref_path), "--max-eval", "1"]) == 0
    ref = {e["contract"]: e for e in json.loads(ref_path.read_text())["contracts"]}
    _, report = _run_gate(tmp_path)
    ours = {e["contract"]: e for e in report["contracts"]}
    for ref_name, port_name in PORT_OF.items():
        want, got = ref[ref_name], ours[port_name]
        for check, verdict in want["checks"].items():
            assert verdict != "violated" and got["checks"][check] != "violated", port_name
            if verdict != "skipped":  # what the reference proves, the port proves
                assert got["checks"][check] == "ok", (port_name, check)
        # the port launches a CUDA kernel behind every contract: memory is
        # checked on all eight (the reference's device RD has no VMEM claim)
        assert got["checks"]["memory"] == "ok"
        assert got["violations"] == want["violations"] == []


def test_unknown_module_selection_exits_2(tmp_path):
    rc = main(["--modules", "repro_torch.analysis.contracts",
               "--report", str(tmp_path / "r.json")])
    assert rc == 2


def test_a_budget_below_the_kernels_fails_memory(tmp_path):
    report_path = tmp_path / "small.json"
    rc = main(["--entry", "rd.step", "--budget-kb", "64", "--max-eval", "1",
               "--report", str(report_path)])
    assert rc == 1
    report = json.loads(report_path.read_text())
    assert {v["check"] for e in report["contracts"] for v in e["violations"]} == {"memory"}


# ---- the negative fixture corpus --------------------------------------------

FIXTURES = {
    "smem_blowup.py": (
        "memory",
        '''
        """smem fixture: a block's dynamic shared memory grows with m², and
        one geometry launches more threads than a block may hold."""
        from repro_torch.analysis.contracts import BlockConfig, contract, span


        def _smem(geom):
            m = geom["m"]
            threads = 2048 if m == 4096 else 256
            return BlockConfig(static_smem=512, dynamic_smem=4 * m * m, threads=threads)


        @contract(
            "fixture.smem-blowup",
            axes=(span("m", 128, 4096, boundaries=(1024,)),),
            backends=("cuda",),
            dispatch=lambda geom: "cuda",
            smem=_smem,
        )
        def fake_kernel(busy, mu):
            raise NotImplementedError
        ''',
    ),
    "range_overflow.py": (
        "range",
        '''
        """range fixture: a direct-product accumulator and a packed field
        one bit too narrow overflow under the declared envelope."""
        from repro_torch.analysis.contracts import Interval, RangeClaim, contract, span


        def _ranges(geom):
            m = geom["m"]
            return [
                RangeClaim("sum of busy*mu over m servers",
                           Interval(0, 1 << 20) * Interval(1, 1 << 4) * m),
                RangeClaim("packed holder word",
                           (Interval(0, m - 1) << 15) | Interval(0, m - 1), bits=30),
            ]


        @contract(
            "fixture.range-overflow",
            axes=(span("m", 128, 1 << 16, boundaries=(1 << 15,)),),
            backends=("cuda",),
            dispatch=lambda geom: "cuda",
            ranges=_ranges,
        )
        def fake_kernel(busy, mu):
            raise NotImplementedError
        ''',
    ),
    "coverage_gap.py": (
        "coverage",
        '''
        """coverage fixture: no fallback past the ceiling (raises), and an
        undeclared route at it."""
        from repro_torch.analysis.contracts import contract, span

        MAX_M = 1 << 15


        def _dispatch(geom):
            m = geom["m"]
            if m > MAX_M:
                raise ValueError(f"no kernel for m={m}")
            if m == MAX_M:
                return "triton"  # not a declared route
            return "cuda"


        @contract(
            "fixture.coverage-gap",
            axes=(span("m", 128, MAX_M, boundaries=(MAX_M,), past=(MAX_M + 1, MAX_M * 2)),),
            backends=("cuda", "torch"),
            dispatch=_dispatch,
        )
        def fake_kernel(busy, mu):
            raise NotImplementedError
        ''',
    ),
    "variant_blowup.py": (
        "recompile",
        '''
        """variant fixture: the kernel variant keyed on the raw width, and
        one non-static signature component."""
        from repro_torch.analysis.contracts import contract, span


        def _signature(geom):
            m = geom["m"]
            if m == 128:
                return ("fixture", [m])
            return ("fixture", m)


        @contract(
            "fixture.variant-blowup",
            axes=(span("m", 128, 1 << 12,
                       boundaries=(256, 512, 1024, 2048, 3000, 3333, 4000)),),
            backends=("cuda",),
            dispatch=lambda geom: "cuda",
            signature=_signature,
            max_signatures=8,
        )
        def fake_kernel(busy, mu):
            raise NotImplementedError
        ''',
    ),
}


def _write_fixture(tmp_path, name):
    path = tmp_path / name
    path.write_text(textwrap.dedent(FIXTURES[name][1]))
    return path


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_fixture_violations_fire(tmp_path, fixture):
    check = FIXTURES[fixture][0]
    report_path = tmp_path / "report.json"
    rc = main(["--modules", str(_write_fixture(tmp_path, fixture)),
               "--report", str(report_path)])
    assert rc == 1
    report = json.loads(report_path.read_text())
    assert report["total_violations"] > 0
    checks_hit = {v["check"] for e in report["contracts"] for v in e["violations"]}
    assert checks_hit == {check}, f"{fixture} must violate {check} alone, got {checks_hit}"
    assert all(e["contract"].startswith("fixture.") for e in report["contracts"])


def test_fixture_selection_does_not_leak_into_default_run(tmp_path):
    import repro_torch.analysis.kernelcheck as kc

    kc._import_module(str(_write_fixture(tmp_path, "coverage_gap.py")))
    assert any(name.startswith("fixture.") for name in CONTRACTS)
    for name, c in CONTRACTS.items():
        if name.startswith("fixture."):
            assert c.module not in set(DEFAULT_MODULES)


# ---- the launchers' formula, the reference's envelope, the sources' ceilings --


def test_contract_smem_is_the_launchers_formula():
    """At the main path's geometries the contracts declare what the
    wrappers pass to the launch."""
    from repro_torch.core import rd_torch, wf_torch  # noqa: F401  (register contracts)
    from repro_torch.kernels import rd as rdk
    from repro_torch.kernels import waterlevel as wl

    for m in (2, 100, 4096, 8192, 8193, 32768):
        n = wl.n_lanes_for(m)
        fused = wl.launch_config(n, fused=True)
        for name in ("wf_torch.groups", "wf_torch.batch", "wf_torch.chain"):
            assert CONTRACTS[name].smem({"m": m, "k": 8, "b": 4, "requested": "cuda"}) == fused
        k1 = wl.launch_config(n, fused=False)
        for name in ("waterlevel.kernel", "waterlevel.kernel-batch"):
            assert CONTRACTS[name].smem({"m": m, "b": 8, "requested": "cuda"}) == k1
    for c, a, m in ((4096, 16, 4096), (128, 2, 12), (16384, 64, 32767)):
        geom = {"c": c, "a": a, "m": m, "device": "cuda", "b": 3}
        cfg = rdk.launch_config(c, m)
        for name in ("rd.step", "rd_torch.device", "rd_torch.chain"):
            assert CONTRACTS[name].smem(geom) == cfg
    # the layouts the launchers check: K1 holds 16,384 lanes in shared
    # memory, the fused kernel 8,192; wider rows take none
    assert wl.launch_config(16384, False).dynamic_smem > 0
    assert wl.launch_config(32768, False).dynamic_smem == 0
    assert wl.launch_config(16384, True).dynamic_smem == 0


def test_envelope_equals_the_reference():
    from repro.core import rd_jax
    from repro.kernels import rd as ref_rd
    from repro.kernels import waterlevel as ref_wl
    from repro_torch.kernels import rd as rdk
    from repro_torch.kernels import waterlevel as wl

    for name in ("WL_BUSY0_MAX", "WL_MU_MAX", "WL_DEMAND_MAX", "WL_TOTAL_DEMAND_MAX",
                 "WL_M_MAX", "WL_LEVEL_MAX", "WL_SUM_BMU_MAX"):
        assert getattr(wl, name) == getattr(ref_wl, name), name
    assert wl.MAX_LANES == ref_wl.PALLAS_MAX_M
    assert wl.BIG == ref_wl._BIG == rdk.BIG == ref_rd._BIG
    for name in ("RD_ENV_BUSY0_MAX", "RD_ENV_TASKS_MAX", "RD_ENV_MU_MAX",
                 "RD_ENV_CHAIN_JOBS_MAX"):
        assert getattr(rdk, name) == getattr(rd_jax, name), name
    assert rdk.RD_MAX_C == ref_rd.RD_PALLAS_MAX_C
    assert rdk.RD_MAX_M == rd_jax.RD_DEVICE_MAX_M


def _constexpr(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    match = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert match, f"{name} not in {source}"
    return int(eval(match.group(1), {}))  # a literal such as 1 << 14


def test_ceilings_equal_the_cuda_sources():
    from repro_torch.kernels import rd as rdk
    from repro_torch.kernels import waterlevel as wl

    assert _constexpr("waterlevel.cu", "kMaxLanes") == wl.MAX_LANES
    assert _constexpr("waterlevel.cu", "kMinLanes") == wl.LANES
    assert _constexpr("waterlevel.cu", "kSmemMaxLanes") == wl.SMEM_MAX_LANES
    assert _constexpr("waterlevel.cu", "kFusedSmemMaxLanes") == wl.FUSED_SMEM_MAX_LANES
    assert _constexpr("waterlevel.cu", "kMaxThreads") == wl.MAX_THREADS
    assert _constexpr("rd_step.cu", "kThreads") == rdk.RD_THREADS
    assert _constexpr("rd_step.cu", "kMaxSlots") == rdk.RD_MAX_C
    assert _constexpr("rd_step.cu", "kMaxRowIds") == rdk.RD_MAX_ROW_IDS
    assert _constexpr("rd_step.cu", "kMaxServers") == rdk.RD_MAX_M
