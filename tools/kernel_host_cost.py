#!/usr/bin/env python3
"""Host time of one RMSNorm (K4) and one decode-attention (K5) call on the card.

Usage::

    python3 tools/kernel_host_cost.py [--before DIR] [--rounds N] [--calls N]

Times, on the host clock, how long a call takes to return (the launch
enqueued, the device not waited for; the device is synchronised after
every round of ``--calls`` calls, so the launch queue never fills), at
K4 on 8 x 2560 bf16 (a decode step's rows of Qwen1.5-4B) and K5 on
(4, 20, 1024, 128) bf16, in these forms:

- ``after``: this checkout's wrapper, as the model calls it;
- ``before`` (with ``--before DIR``, the ``src/`` of another tree, e.g.
  the parent commit unpacked beside this one): that tree's wrapper,
  imported under another package name into the same process;
- ``custom_op``: this checkout's wrapper registered as a
  ``torch.library.custom_op`` with a fake (shape) implementation and
  called through the dispatcher, the cost of that form of the dry run's
  meta path;
- ``in_counting_scope``: this checkout's wrapper inside the dry run's
  ``kernels._tensors.counting`` scope, which adds the kernel's counts.

The forms take turns, ``--rounds`` rounds of ``--calls`` calls each after
a warm-up, so a slow spell of the host falls on all of them; the median
of every form's per-call times is printed, with the card's name and
power limit, as one JSON line.  Exits non-zero without a card.
"""

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _alias(src: Path, name: str):
    """The package ``repro_torch`` under ``src`` imported as ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, src / "repro_torch" / "__init__.py",
        submodule_search_locations=[str(src / "repro_torch")])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def main() -> int:  # no postponed annotations: custom_op reads them
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--before", default=None, help="src/ of the tree to compare with")
    parser.add_argument("--rounds", type=int, default=20)
    parser.add_argument("--calls", type=int, default=250)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kernel_host_cost: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _tensors
    from repro_torch.kernels import decode_attention as dak
    from repro_torch.kernels import rmsnorm as rnk

    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    x = torch.randn(8, 2560, generator=gen, device="cuda").to(bf16)
    g = torch.randn(2560, generator=gen, device="cuda").to(bf16)
    q = torch.randn(4, 20, 128, generator=gen, device="cuda").to(bf16)
    k = torch.randn(4, 20, 1024, 128, generator=gen, device="cuda").to(bf16)
    v = torch.randn(4, 20, 1024, 128, generator=gen, device="cuda").to(bf16)
    pos = torch.full((4,), 1023, dtype=torch.int32, device="cuda")

    @torch.library.custom_op("repro_host_cost::rmsnorm", mutates_args=())
    def rms_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return rnk.rmsnorm(x, g)

    @rms_op.register_fake
    def _(x, g):
        return torch.empty_like(x)

    @torch.library.custom_op("repro_host_cost::decode_attention", mutates_args=())
    def dec_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        return dak.decode_attention(q, k, v, pos)

    @dec_op.register_fake
    def _(q, k, v, pos):
        return torch.empty_like(q)

    forms = {
        "rmsnorm": {"after": lambda: rnk.rmsnorm(x, g), "custom_op": lambda: rms_op(x, g)},
        "decode_attention": {"after": lambda: dak.decode_attention(q, k, v, pos),
                             "custom_op": lambda: dec_op(q, k, v, pos)},
    }
    if args.before:
        old = _alias(Path(args.before).resolve(), "repro_torch_before")
        importlib.import_module("repro_torch_before.kernels.rmsnorm")
        importlib.import_module("repro_torch_before.kernels.decode_attention")
        forms["rmsnorm"]["before"] = lambda: old.kernels.rmsnorm.rmsnorm(x, g)
        forms["decode_attention"]["before"] = (
            lambda: old.kernels.decode_attention.decode_attention(q, k, v, pos))
    out = {}
    for name, by_form in forms.items():
        by_form["in_counting_scope"] = by_form["after"]
        times = {form: [] for form in by_form}
        for fn in by_form.values():  # builds, first launches, warm-up
            for _ in range(100):
                fn()
        torch.cuda.synchronize()
        for _ in range(args.rounds):
            for form, fn in by_form.items():
                scope = _tensors.counting() if form == "in_counting_scope" else nullcontext()
                with scope:
                    for _ in range(args.calls):
                        t0 = time.perf_counter()
                        fn()
                        times[form].append(time.perf_counter() - t0)
                torch.cuda.synchronize()
        out[name] = {form: statistics.median(ts) * 1e6 for form, ts in times.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(json.dumps({"before": args.before, "card": card, "rounds": args.rounds,
                      "calls_per_round": args.calls,
                      "shapes": {"rmsnorm": [8, 2560], "decode_attention": [4, 20, 1024, 128]},
                      "dtype": "bfloat16", "host_us_median": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
