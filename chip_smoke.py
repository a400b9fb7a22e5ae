#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's main path on one NVIDIA GPU and check it.

Usage::

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (any failure exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels — each kernel against its plain PyTorch version on the card,
   bit for bit, at widths up to the kernel's 32768-lane ceiling;
4. main path — the online scheduler (``SchedulingEngine`` with
   ``wf_torch``) on a bursty trace at 4096 servers under ``fifo`` (the
   burst chain) and ``ocwf-acc``, each schedule identical to the host
   ``wf`` on the same trace; then the independent-problems batch entry
   point ``water_filling_torch_batch`` over the trace's bursts.  Launch
   counts are zeroed just before each path and read just after;
5. timings — CUDA-event times of the kernel and its plain version, and
   the chained burst admission's wall time.

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  The script needs a CUDA device and
the repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import AssignmentProblem, water_filling  # noqa: E402
from repro_torch.core import wf_torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import waterlevel as wl  # noqa: E402
from repro_torch.runtime import SchedulingEngine, make_policy  # noqa: E402
from repro_torch.traces import generate  # noqa: E402

# main-path configuration: ~4,000 machines as in Alibaba's
# cluster-trace-v2018, the paper segment's per-server load kept
# (113,653 tasks per 100 servers, scaled to 4096 servers)
M_SERVERS = 4096
N_JOBS = 1000
TOTAL_TASKS = 4_655_227

KERNEL_WIDTHS = (1, 100, 4096, 16384, 32768)
KERNEL_BATCHES = (1, 8)
KERNEL_CASES = ("random", "ties", "one-available", "demand0", "boundary")
TIMED = ((4096, 1), (16384, 1), (32768, 1), (4096, 8))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit
# rate outside the tensor cores (the table's fp32 entry; the kernel's
# arithmetic is 32-bit integer, which issues no faster)
HBM_BYTES_PER_S = 3.35e12
PEAK_32BIT_OPS_PER_S = 67e12
SMEM_BYTES_PER_CLOCK = 128  # one SM's shared-memory bandwidth
OPS_PER_COMPARE_EXCHANGE = 3  # one 64-bit compare, two selects
OPS_PER_LANE = 12  # scans, ceiling division, segment test, caps, clamp


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip().splitlines()[0]


# ---- bounds ------------------------------------------------------------------


def compare_exchanges(n: int) -> int:
    log = n.bit_length() - 1
    return n // 2 * log * (log + 1) // 2


def card_bound_ms(n: int, bsz: int) -> tuple[float, str]:
    """Least time for the kernel's work on the whole card: each input read
    and each output written once over HBM, or its 32-bit operations over
    the card's peak rate, whichever is larger."""
    nbytes = bsz * (16 * n + 8)  # b, w in; take, idx out; demand, level
    ops = bsz * (OPS_PER_COMPARE_EXCHANGE * compare_exchanges(n) + OPS_PER_LANE * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_32BIT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sm_smem_bound_us(n: int, sm_clock_hz: float) -> float:
    """The one-block design's own floor: the sort's shared-memory traffic
    (two 12-byte lanes read and written per compare-exchange) at one SM's
    shared-memory bandwidth."""
    return compare_exchanges(n) * 4 * 12 / (SMEM_BYTES_PER_CLOCK * sm_clock_hz) * 1e6


# ---- inputs ------------------------------------------------------------------


def padded_rows(rng: np.random.Generator, m: int, bsz: int, case: str):
    """Pre-masked, padded (B, n_lanes) rows as the wf_torch path builds
    them; every row keeps one available lane with positive capacity."""
    busy = rng.integers(0, 25, (bsz, m))
    mu = rng.integers(0, 6, (bsz, m))
    mask = rng.random((bsz, m)) < 0.6
    demand = rng.integers(0, 12 * m + 50, bsz)
    rows = np.arange(bsz)
    if case == "ties":
        busy = rng.integers(0, 3, (bsz, m))
    elif case == "one-available":
        mask[:] = False
        mask[rows, rng.integers(0, m, bsz)] = True
    elif case == "demand0":
        demand[:] = 0
    elif case == "boundary":  # busy just under the BIG sentinel
        busy[:, 0] = wl.BIG - rng.integers(1, 1000, bsz)
        mu[:] = 1
        mask[:] = True
        demand = rng.integers(0, 50, bsz)
    dead = ~(mask & (mu > 0)).any(axis=1)
    pick = rng.integers(0, m, bsz)
    mask[rows[dead], pick[dead]] = True
    mu[rows[dead], pick[dead]] = np.maximum(1, mu[rows[dead], pick[dead]])
    n = wl.n_lanes_for(m)
    b = np.full((bsz, n), wl.BIG, np.int32)
    w = np.zeros((bsz, n), np.int32)
    b[:, :m] = np.where(mask, busy, wl.BIG)
    w[:, :m] = np.where(mask, mu, 0)
    dev = torch.device("cuda")
    return (
        torch.from_numpy(b).to(dev),
        torch.from_numpy(w).to(dev),
        torch.from_numpy(demand.astype(np.int32)).to(dev),
    )


def main_path_rows(rng: np.random.Generator, n: int, bsz: int):
    """Rows shaped like the engine's: ~10 of the lanes available."""
    b = np.full((bsz, n), wl.BIG, np.int32)
    w = np.zeros((bsz, n), np.int32)
    for r in range(bsz):
        srv = rng.choice(n, 10, replace=False)
        b[r, srv] = rng.integers(0, 200, 10)
        w[r, srv] = rng.integers(3, 6, 10)
    d = rng.integers(100, 5000, bsz).astype(np.int32)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in (b, w, d))


def cuda_ms(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bursts_of(jobs) -> list[list]:
    by_slot: dict[int, list] = {}
    for j in jobs:
        if j.n_tasks > 0:
            by_slot.setdefault(j.arrival, []).append(j)
    return [by_slot[s] for s in sorted(by_slot)]


# ---- phases ------------------------------------------------------------------


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    out = {
        "phase": "device",
        "name": name,
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "max_sm_clock_mhz": clock_mhz,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(out)
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    results = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [
        line.strip()
        for r in results
        for line in r.log.splitlines()
        if "registers" in line or "Compiling entry" in line
    ]
    emit({
        "phase": "build",
        "seconds": seconds,
        "libraries": [r.path.name for r in results],
        "built": [r.built for r in results],
        "ptxas": ptxas,
    })


def phase_kernels(seed: int) -> dict[str, int]:
    """Kernel vs plain on identical inputs; returns the max abs error per
    kernel name."""
    rng = np.random.default_rng(seed)
    worst = {"waterlevel": 0, "waterlevel_batch": 0}
    checked = []
    for m in KERNEL_WIDTHS:
        for bsz in KERNEL_BATCHES:
            for case in KERNEL_CASES:
                b, w, d = padded_rows(rng, m, bsz, case)
                got = wl.waterlevel_sorted(b, w, d)
                want = wl.waterlevel_sorted_plain(b, w, d)
                torch.cuda.synchronize()
                err = max(
                    int((g.long() - p.long()).abs().max()) for g, p in zip(got, want)
                )
                name = "waterlevel" if bsz == 1 else "waterlevel_batch"
                worst[name] = max(worst[name], err)
                if err != 0:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: m={m} "
                        f"B={bsz} case={case} max_abs_err={err}"
                    )
                checked.append(f"{m}x{bsz}:{case}")
    emit({
        "phase": "kernels",
        "held": ["waterlevel", "waterlevel_batch"],
        "tolerance": 0,
        "cases": len(checked),
        "widths": list(KERNEL_WIDTHS),
        "batches": list(KERNEL_BATCHES),
        "max_abs_err": worst,
    })
    return worst


def phase_main_path(seed: int) -> tuple[list, dict]:
    jobs = generate(
        "bursty",
        n_servers=M_SERVERS,
        n_jobs=N_JOBS,
        total_tasks=TOTAL_TASKS,
        seed=seed,
    )
    bursts = bursts_of(jobs)
    n_arrivals = sum(len(b) for b in bursts)
    launches = {"waterlevel": 0, "waterlevel_batch": 0}
    for ordering in ("fifo", "ocwf-acc"):
        torch.cuda.synchronize()
        wl.reset_counts()
        t0 = time.perf_counter()
        dev = SchedulingEngine(M_SERVERS, make_policy("wf_torch", ordering)).run(jobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(wl.COUNTS)
        t0 = time.perf_counter()
        host = SchedulingEngine(M_SERVERS, make_policy("wf", ordering)).run(jobs)
        host_wall = time.perf_counter() - t0
        identical = (
            dev.jct == host.jct
            and dev.makespan == host.makespan
            and dev.failed_jobs == host.failed_jobs
        )
        n_launch = counts["waterlevel"] + counts["waterlevel_batch"]
        emit({
            "phase": "main_path",
            "ordering": ordering,
            "servers": M_SERVERS,
            "jobs": len(jobs),
            "tasks": sum(j.n_tasks for j in jobs),
            "bursts": len(bursts),
            "mean_jct": dev.mean_jct,
            "p99_jct": dev.jct_percentile(99),
            "makespan": dev.makespan,
            "failed_jobs": len(dev.failed_jobs),
            "engine_wall_s": wall,
            "mean_overhead_ms": dev.mean_overhead_s * 1e3,
            "launches": counts,
            "launches_per_arrival": n_launch / n_arrivals,
            "launches_per_burst": n_launch / len(bursts),
            "host_wf_wall_s": host_wall,
            "identical_to_host_wf": identical,
        })
        if not identical:
            raise AssertionError(f"{ordering}: wf_torch schedule differs from host wf")
        if counts["waterlevel"] == 0 or counts["plain"] != 0:
            raise AssertionError(f"{ordering}: main path bypassed the kernel: {counts}")
        for k in launches:
            launches[k] += counts[k]

    # the independent-problems entry point over the same bursts
    busy = np.random.default_rng(seed + 1).integers(0, 50, M_SERVERS)
    multi = [b for b in bursts if len(b) > 1]
    torch.cuda.synchronize()
    wl.reset_counts()
    t0 = time.perf_counter()
    for burst in multi:
        problems = [AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups) for j in burst]
        got = wf_torch.water_filling_torch_batch(problems)
        for p, a in zip(problems, got):
            want = water_filling(p)
            if a.alloc != want.alloc or a.phi != want.phi:
                raise AssertionError("water_filling_torch_batch differs from host wf")
    wall = time.perf_counter() - t0
    counts = dict(wl.COUNTS)
    emit({
        "phase": "batch_path",
        "bursts": len(multi),
        "problems": sum(len(b) for b in multi),
        "wall_s": wall,
        "launches": counts,
        "identical_to_host_wf": True,
    })
    if counts["waterlevel_batch"] == 0 or counts["plain"] != 0:
        raise AssertionError(f"batch path bypassed the kernel: {counts}")
    launches["waterlevel_batch"] += counts["waterlevel_batch"]
    return bursts, launches


def phase_timings(seed: int, bursts: list, sm_clock_hz: float) -> dict:
    rng = np.random.default_rng(seed + 2)
    rows = []
    by_shape = {}
    for n, bsz in TIMED:
        b, w, d = main_path_rows(rng, n, bsz)
        iters = 200 if n <= 4096 else 50

        def kernel():
            return wl.waterlevel_sorted(b, w, d)

        def plain():
            return wl.waterlevel_sorted_plain(b, w, d)

        # interleaved kernel, plain, plain, kernel on the same inputs
        k1 = cuda_ms(kernel, iters)
        p1 = cuda_ms(plain, iters)
        p2 = cuda_ms(plain, iters)
        k2 = cuda_ms(kernel, iters)
        bound, bound_by = card_bound_ms(n, bsz)
        row = {
            "n_lanes": n,
            "batch": bsz,
            "kernel_ms": (k1 + k2) / 2,
            "kernel_ms_runs": [k1, k2],
            "plain_ms": (p1 + p2) / 2,
            "plain_ms_runs": [p1, p2],
            "bound_ms": bound,
            "bound_by": bound_by,
            # rows run on separate SMs, so the per-row floor holds for B rows
            "sm_smem_bound_ms": sm_smem_bound_us(n, sm_clock_hz) / 1e3,
        }
        rows.append(row)
        by_shape[(n, bsz)] = row

    # chained burst admission: host wall per call (each ends in one
    # .cpu()), then the same calls under the profiler for device time
    busy = np.zeros(M_SERVERS, np.int64)
    calls = [
        [AssignmentProblem(busy=busy, mu=j.mu, groups=j.groups) for j in burst]
        for burst in bursts
        if len(burst) > 1
    ][:100]
    wl.reset_counts()
    t0 = time.perf_counter()
    for problems in calls:
        wf_torch.water_filling_torch_chain(problems)
    chain_ms = (time.perf_counter() - t0) / len(calls) * 1e3
    launches = wl.COUNTS["waterlevel"] / len(calls)
    device = profile_device_us(
        lambda: [wf_torch.water_filling_torch_chain(p) for p in calls]
    )
    device_ms = {k: v / len(calls) / 1e3 for k, v in device.items()}
    total = sum(device_ms.values())
    emit({
        "phase": "timings",
        "kernels": rows,
        "chain_ms_per_burst": chain_ms,
        "chain_bursts": len(calls),
        "chain_launches_per_burst": launches,
        "chain_device_ms_per_burst": total,
        "chain_device_busy_share": total / chain_ms if total else None,
        "chain_device_ms_per_burst_by_kernel": dict(
            sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
        ),
    })
    return by_shape


def profile_device_us(fn) -> dict[str, float]:
    """Device time per kernel name (µs) over one run of ``fn``, from
    ``torch.profiler``; empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0.0) + us
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    dev = phase_device()
    phase_build()
    worst = phase_kernels(args.seed)
    bursts, launches = phase_main_path(args.seed)
    timed = phase_timings(args.seed, bursts, dev["max_sm_clock_mhz"] * 1e6)
    source = "src/repro_torch/kernels/csrc/waterlevel.cu"
    summary = []
    for name, replaces, shape in (
        ("waterlevel", "src/repro/kernels/waterlevel.py:329", (4096, 1)),
        ("waterlevel_batch", "src/repro/kernels/waterlevel.py:373", (4096, 8)),
    ):
        row = timed[shape]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call computes this function
        })
    emit({"kernels": summary})
    print(dev["nvidia_smi"], flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
