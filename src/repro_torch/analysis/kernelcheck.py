"""kernelcheck — the geometry-contract verifier of the port, for CUDA.

Run as ``python -m repro_torch.analysis.kernelcheck [--budget-kb N]
[--report PATH]``.  The port's counterpart of
``repro/analysis/kernelcheck.py``: it imports the modules that declare
:func:`repro_torch.analysis.contracts.contract` entries (default: the
water-level and RD kernel wrappers plus the ``wf_torch``/``rd_torch``
adapters), sweeps each contract's boundary-focused geometry lattice, and
proves four properties per entry point **without a card**:

- **memory** — at every point that launches the CUDA kernel, one block's
  shared memory (static + dynamic, as the wrapper passes it to the
  launch) stays within the budget (``--budget-kb``, default one H100
  block's opt-in shared memory, 227 KiB) and its threads within the
  card's 1024 a block;
- **range** — interval claims over the declared input envelope fit their
  dtypes / bit-fields (prefix sums, eq. 2 carries, packed sort keys);
- **coverage** — every lattice point, including past-ceiling probes,
  dispatches to a declared route (plain and host fallbacks count; an
  exception or an unknown route name is a gap);
- **variant surface** — the sweep's distinct kernel-variant signatures
  stay within the declared bound, every signature component is static,
  and equal signatures imply identical input shapes.

A sample of admissible device points is additionally run through the
contract's ``abstract`` callable — zero-filled CPU tensors through the
wrapper's argument checks and its plain version — so shape or dtype
errors surface here rather than on the card.  Results land in a
machine-readable JSON report (``--report``, default
``results/KERNELCHECK_TORCH.json``); exit status is 0 iff no contract
has violations.

Importing this module stays stdlib-only; running the checks imports the
contracted modules, and so torch.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from typing import Any

from .contracts import CONTRACTS, KernelContract, lattice

__all__ = [
    "DEFAULT_BUDGET_BYTES",
    "DEFAULT_MODULES",
    "MAX_THREADS_PER_BLOCK",
    "check_contract",
    "main",
]

# Modules whose import registers the port's kernel entry-point contracts.
DEFAULT_MODULES = (
    "repro_torch.kernels.waterlevel",
    "repro_torch.kernels.rd",
    "repro_torch.core.wf_torch",
    "repro_torch.core.rd_torch",
    "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.flash_attention",
)

# One H100 block's opt-in shared memory (cudaDevAttrMaxSharedMemoryPerBlockOptin:
# 227 KiB of the SM's 228 KiB).
DEFAULT_BUDGET_BYTES = 227 * 1024
MAX_THREADS_PER_BLOCK = 1024

DEFAULT_REPORT = os.path.join("results", "KERNELCHECK_TORCH.json")

_STATIC_LEAVES = (int, str, bool, type(None))


@dataclasses.dataclass(frozen=True)
class CheckViolation:
    contract: str
    check: str  # memory | range | coverage | recompile | abstract-eval
    geometry: dict[str, Any] | None
    detail: str

    def as_json(self) -> dict[str, Any]:
        return {
            "contract": self.contract,
            "check": self.check,
            "geometry": self.geometry,
            "detail": self.detail,
        }


def _signature_static(sig: tuple) -> str | None:
    """Return a complaint if any signature leaf is not a static scalar."""
    for leaf in sig:
        if not isinstance(leaf, _STATIC_LEAVES):
            return (
                f"non-static signature component {leaf!r} "
                f"({type(leaf).__name__}): the kernel variant would depend "
                "on runtime data"
            )
    return None


def _sample(points: list, limit: int) -> list:
    """Evenly spaced sample including both extremes."""
    if limit <= 0 or len(points) <= limit:
        return list(points)
    if limit == 1:
        return [points[-1]]
    step = (len(points) - 1) / (limit - 1)
    idx = sorted({round(i * step) for i in range(limit)})
    return [points[i] for i in idx]


def check_contract(
    c: KernelContract,
    *,
    budget_bytes: int = DEFAULT_BUDGET_BYTES,
    eval_limit: int | None = None,
) -> tuple[dict[str, Any], list[CheckViolation]]:
    """Sweep one contract's lattice; return (report entry, violations)."""
    violations: list[CheckViolation] = []
    backend_hist: dict[str, int] = {}
    signatures: dict[tuple, dict[str, Any]] = {}
    device_points: list[tuple[dict[str, Any], str]] = []
    peak_smem = 0
    n_points = 0

    for geom, admissible in lattice(c):
        n_points += 1
        try:
            backend = c.dispatch(dict(geom))
        except Exception as exc:  # a geometry with no dispatch path is a gap
            violations.append(
                CheckViolation(c.name, "coverage", geom, f"dispatch raised {exc!r}")
            )
            continue
        if backend not in c.backends:
            violations.append(
                CheckViolation(
                    c.name,
                    "coverage",
                    geom,
                    f"dispatch returned {backend!r}, not one of {c.backends}",
                )
            )
            continue
        backend_hist[backend] = backend_hist.get(backend, 0) + 1

        if backend in c.device_backends and c.smem is not None:
            cfg = c.smem(dict(geom))
            total = cfg.smem_bytes
            peak_smem = max(peak_smem, total)
            if total > budget_bytes:
                violations.append(
                    CheckViolation(
                        c.name,
                        "memory",
                        geom,
                        f"shared memory {total} B a block > budget "
                        f"{budget_bytes} B (static {cfg.static_smem} B, "
                        f"dynamic {cfg.dynamic_smem} B)",
                    )
                )
            if not 1 <= cfg.threads <= MAX_THREADS_PER_BLOCK:
                violations.append(
                    CheckViolation(
                        c.name,
                        "memory",
                        geom,
                        f"{cfg.threads} threads a block outside "
                        f"[1, {MAX_THREADS_PER_BLOCK}]",
                    )
                )

        if not (admissible and backend in c.device_backends):
            continue
        device_points.append((geom, backend))

        if c.ranges is not None:
            for claim in c.ranges(dict(geom)):
                msg = claim.check()
                if msg is not None:
                    violations.append(CheckViolation(c.name, "range", geom, msg))

        if c.signature is not None:
            sig = c.signature(dict(geom))
            complaint = _signature_static(sig)
            if complaint is not None:
                violations.append(
                    CheckViolation(c.name, "recompile", geom, complaint)
                )
            else:
                signatures.setdefault(sig, geom)

    if (
        c.signature is not None
        and c.max_signatures is not None
        and len(signatures) > c.max_signatures
    ):
        violations.append(
            CheckViolation(
                c.name,
                "recompile",
                None,
                f"sweep induces {len(signatures)} distinct kernel-variant "
                f"signatures (declared bound {c.max_signatures}) — unbounded "
                "variant growth for this scenario class",
            )
        )

    n_eval = 0
    if c.abstract is not None and device_points:
        limit = c.eval_points if eval_limit is None else min(eval_limit, c.eval_points)
        sig_shapes: dict[tuple, tuple] = {}
        for geom, backend in _sample(device_points, limit):
            try:
                fn, args = c.abstract(dict(geom))
                fn(*args)
                n_eval += 1
            except Exception as exc:
                violations.append(
                    CheckViolation(
                        c.name,
                        "abstract-eval",
                        geom,
                        f"the wrapper's checks or plain version failed: {exc!r}",
                    )
                )
                continue
            if c.signature is None:
                continue
            sig = c.signature(dict(geom))
            shapes = _shapes(args)
            prev = sig_shapes.setdefault(sig, shapes)
            if prev != shapes:
                violations.append(
                    CheckViolation(
                        c.name,
                        "recompile",
                        geom,
                        f"signature {sig!r} maps to distinct input "
                        f"shapes {prev} vs {shapes} — the variant key "
                        "underdetermines the launch (shape is data-dependent)",
                    )
                )

    checks = {
        "memory": "skipped" if c.smem is None else "ok",
        "range": "skipped" if c.ranges is None else "ok",
        "coverage": "ok",
        "recompile": "skipped" if c.signature is None else "ok",
        "abstract-eval": "skipped" if c.abstract is None else "ok",
    }
    for v in violations:
        checks[v.check] = "violated"

    entry = {
        "contract": c.name,
        "entry": c.entry,
        "module": c.module,
        "lattice_points": n_points,
        "backends": dict(sorted(backend_hist.items())),
        "distinct_signatures": len(signatures) if c.signature is not None else None,
        "max_signatures": c.max_signatures,
        "peak_smem_bytes": peak_smem if c.smem is not None else None,
        "abstract_evals": n_eval,
        "checks": checks,
        "violations": [v.as_json() for v in violations],
        "notes": c.notes,
    }
    return entry, violations


def _shapes(args: tuple) -> tuple:
    """The shapes of an abstract call's tensor arguments (and of the
    buffers of any argument that carries them, such as an RD state)."""
    out: list[tuple[int, ...]] = []
    for a in args:
        if hasattr(a, "shape"):
            out.append(tuple(int(d) for d in a.shape))
        elif hasattr(a, "buffers"):
            out.extend(tuple(int(d) for d in t.shape) for t in a.buffers().values())
    return tuple(out)


def _import_module(spec: str):
    """Import a contract module by dotted name or filesystem path (a file
    under a module name of its own: the reference's kernelcheck names its
    fixtures ``kernelcheck_fixture_<stem>``, and one process may load a
    fixture of each package with the same file name)."""
    if spec.endswith(".py") or os.sep in spec:
        name = "repro_torch_kernelcheck_fixture_" + os.path.splitext(os.path.basename(spec))[0]
        if name in sys.modules:
            return sys.modules[name]
        loader_spec = importlib.util.spec_from_file_location(name, spec)
        if loader_spec is None or loader_spec.loader is None:
            raise ImportError(f"cannot load contract module from {spec!r}")
        mod = importlib.util.module_from_spec(loader_spec)
        sys.modules[name] = mod
        loader_spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(spec)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.kernelcheck",
        description="geometry-contract verifier for the port's CUDA kernels",
    )
    parser.add_argument(
        "--modules",
        nargs="+",
        default=list(DEFAULT_MODULES),
        help="contract modules to import (dotted names or .py paths); "
        "only contracts defined by these modules are checked",
    )
    parser.add_argument(
        "--entry",
        action="append",
        default=None,
        help="check only the named contract(s); repeatable",
    )
    parser.add_argument(
        "--budget-kb",
        type=float,
        default=DEFAULT_BUDGET_BYTES / 1024,
        help="shared memory a block may use, in KiB (default: %(default)s, "
        "an H100 block's opt-in limit)",
    )
    parser.add_argument(
        "--max-eval",
        type=int,
        default=None,
        help="cap the number of abstract-eval points per contract",
    )
    parser.add_argument(
        "--report",
        default=DEFAULT_REPORT,
        help="JSON report path (default: %(default)s)",
    )
    parser.add_argument(
        "--list", action="store_true", help="list registered contracts and exit"
    )
    args = parser.parse_args(argv)

    module_names = []
    for spec in args.modules:
        mod = _import_module(spec)
        module_names.append(mod.__name__)

    selected = [
        c
        for _, c in sorted(CONTRACTS.items())
        if c.module in module_names
        and (args.entry is None or c.name in args.entry)
    ]
    if args.list:
        for c in selected:
            print(f"{c.name}: {c.entry} ({len(c.axes)} axes)")  # reprolint: disable=R008 the port's analyzer CLI (R008 exempts repro.analysis by name)
        return 0
    if not selected:
        print("kernelcheck: no contracts registered by the requested modules")  # reprolint: disable=R008 the port's analyzer CLI (R008 exempts repro.analysis by name)
        return 2

    budget_bytes = int(args.budget_kb * 1024)
    entries = []
    all_violations: list[CheckViolation] = []
    for c in selected:
        entry, violations = check_contract(
            c, budget_bytes=budget_bytes, eval_limit=args.max_eval
        )
        entries.append(entry)
        all_violations.extend(violations)
        status = "OK" if not violations else f"{len(violations)} violation(s)"
        print(  # reprolint: disable=R008 the port's analyzer CLI (R008 exempts repro.analysis by name)
            f"kernelcheck: {c.name}: {entry['lattice_points']} lattice points, "
            f"backends {entry['backends']}, {status}"
        )

    report = {
        "tool": "kernelcheck",
        "budget_bytes": budget_bytes,
        "modules": module_names,
        "contracts": entries,
        "total_violations": len(all_violations),
    }
    report_dir = os.path.dirname(args.report)
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
    with open(args.report, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(f"kernelcheck: report written to {args.report}")  # reprolint: disable=R008 the port's analyzer CLI (R008 exempts repro.analysis by name)

    if all_violations:
        for v in all_violations:
            print(f"kernelcheck: VIOLATION [{v.check}] {v.contract}: {v.detail}")  # reprolint: disable=R008 the port's analyzer CLI (R008 exempts repro.analysis by name)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
