#!/usr/bin/env python3
"""Time the decode-attention kernel (K5) across GQA group widths on the card.

Usage::

    python3 tools/decode_attention_groups.py [--seed S]

One query token per sequence, bf16, 4 sequences of 4 KV heads over a
full 1024-position cache of head width 128 (Qwen3-MoE's decode shape at
a group of 16), at groups of 1, 2, 4, 8, 12 and 16 query heads per KV
head, and Qwen3-32B's 64 / 8 heads: per shape the kernel's device time
per call (``torch.profiler``), its plain PyTorch version's and
``F.scaled_dot_product_attention(enable_gqa=True)``'s, the bound (each
input read once, each output written once, over 3.35 TB/s; the products
over the dense bf16 rate, whichever is larger), the group's slices and
split plan, and the kernel's largest error against the plain version.
The cache bytes stay the same across the groups while the query heads
grow, so the rows show what a query head costs the kernel.  Prints one
JSON line per shape, then the card's name and power limit; exits
non-zero without a card or when the kernel disagrees with its plain
version past bf16's tolerance (``chip_smoke.py``'s).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from repro_torch.kernels import decode_attention as dak  # noqa: E402

SHAPES = [(4, 4 * g, 4, 1024, 128) for g in (1, 2, 4, 8, 12, 16)] + [(4, 64, 8, 1024, 128)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_attention_groups: no CUDA device available", file=sys.stderr)
        return 2
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad = []
    for b, h, hkv, t, hd in SHAPES:
        q = cs._randn(gen, (b, h, hd), bf16)
        k, v = cs._randn(gen, (b, hkv, t, hd), bf16), cs._randn(gen, (b, hkv, t, hd), bf16)
        pos = torch.full((b,), t - 1, dtype=torch.int32, device="cuda")
        mask = (torch.arange(t, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
        err, ok = cs._model_err(dak.decode_attention(q, k, v, pos),
                                dak.decode_attention_plain(q, k, v, pos), "bfloat16")
        times = cs._time_three(
            lambda: dak.decode_attention(q, k, v, pos),
            lambda: dak.decode_attention_plain(q, k, v, pos),
            lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                   enable_gqa=True),
            200,
        )
        keys = b * t
        bound, by = cs._bound(2 * (2 * b * h * hd + 2 * keys * hkv * hd) + 4 * b,
                              4 * keys * h * hd, cs.PEAK_BF16_FLOPS)
        row = {"shape": [b, h, hkv, t, hd], "group": h // hkv,
               "slices": dak.group_slices(h // hkv),
               "chunk_splits": dak.split_plan(b, hkv, t, sms, h // hkv),
               **times, "bound_ms": bound, "bound_by": by, "max_abs_err": err, "ok": ok}
        print(json.dumps(row), flush=True)
        if not ok:
            bad.append(row["shape"])
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    if bad:
        print(f"decode_attention_groups: kernel disagrees with plain at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
