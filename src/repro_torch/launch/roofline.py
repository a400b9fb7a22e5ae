"""Roofline bounds: per-device FLOPs, bytes and collective traffic of the
single-pod cells, against an H100's data-sheet peaks.

The port's counterpart of ``repro/launch/roofline.py``.  The reference
lowers unrolled probes at two depths and extrapolates, because XLA's cost
analysis counts a ``while`` body once whatever its trip count, and adds
an analytic K/V re-stream term that its chunked attention hides.  The
port needs neither: the dry run (:func:`repro_torch.launch.dryrun.
count_cell`) runs the eager step on ``meta`` at full depth, every layer
counted, and the flash-attention kernel's own rules count its products
and its K/V re-reads per query tile (``kernels/flash_attention.py``).
So there is no extrapolation and no ``FORCE_DIRECT``; :func:`_probe_depths`
stays only for the test that shows the counts are linear in depth,
which is what the reference's extrapolation assumes.

Hardware model, an H100 SXM5's data-sheet peaks (not measured here, and
no timing): 989 TFLOP/s dense bf16 (:data:`PEAK_FLOPS`), 3.35 TB/s HBM
(:data:`HBM_BW`); collectives under a node model of 8 GPUs a node on
NVLink at 450 GB/s each way (:data:`NVLINK_BW`) and one 400 Gb/s NIC
(50 GB/s, :data:`NETWORK_BW`) a GPU between nodes, a collective's group
taking the slower link it spans.  With the rank-major (data=16,
model=16) layout a ``model`` group (16 consecutive ranks) spans two
nodes and a ``data`` group sixteen, so both cross the network.  Each
term is a bound in seconds per device: compute ``flops / PEAK_FLOPS``,
memory ``bytes / HBM_BW``, collective ``wire bytes / link``; the largest
is ``dominant``.  ``model_flops`` is the reference's: ``6 x`` (train) or
``2 x`` active parameters (``ModelConfig.active_param_count()`` less the
embedding, from ``param_count()``, which differs from the built model's
count as in the reference) times the step's tokens.

Run:  PYTHONPATH=src python -m repro_torch.launch.roofline [--arch A]
      [--shape S] [--out results/roofline_torch]
"""

from __future__ import annotations

import argparse
import json
import os

from ..configs import ARCHS, get_config
from ..configs.shapes import SHAPES, applicable, get_shape
from ..models.config import ModelConfig
from ..obs.clock import perf_counter
from .dryrun import NODE_GPUS, count_cell

__all__ = ["HARDWARE", "main", "probe"]

PEAK_FLOPS = 989e12  # H100 SXM5 data sheet: dense bf16
HBM_BW = 3.35e12  # H100 SXM5 data sheet: HBM3
NVLINK_BW = 450e9  # each way, within a node
NETWORK_BW = 50e9  # one 400 Gb/s NIC a GPU, between nodes
CHIPS = 256  # the roofline table is single-pod
HARDWARE = {
    "card": "NVIDIA H100 SXM5, data-sheet peaks (not measured)",
    "peak_flops_bf16": PEAK_FLOPS,
    "hbm_bytes_per_s": HBM_BW,
    "node": f"{NODE_GPUS} GPUs a node; NVLink {NVLINK_BW:.0f} B/s each way within it; "
            f"one 400 Gb/s NIC ({NETWORK_BW:.0f} B/s) a GPU between nodes; a collective's "
            "group takes the slower link it spans",
}
NOTE = ("bounds under data-sheet peaks, not timings: per-device counts of one rank's "
        "eager step on the meta device (repro_torch.launch.dryrun)")
MODEL_FLOPS_SOURCE = ("the reference's: 6x (train) or 2x ModelConfig.active_param_count() "
                      "less the embedding, from param_count(), times the tokens; "
                      "param_count() differs from the built model's parameter count, "
                      "as in the reference")

RESULTS_DEFAULT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                               "roofline_torch")


def _probe_depths(cfg: ModelConfig) -> tuple[ModelConfig, ModelConfig, int, int]:
    """(shallow cfg, deeper cfg, shallow units, full units), as the
    reference's: 2 and 4 layers (zamba2: hybrid periods; encdec: encoder
    and decoder together)."""
    if cfg.block_pattern == "zamba2":
        p = cfg.hybrid_period
        return cfg.scaled(n_layers=2 * p), cfg.scaled(n_layers=4 * p), 2, cfg.n_layers // p
    if cfg.block_pattern == "encdec":
        return (cfg.scaled(n_layers=2, n_encoder_layers=2),
                cfg.scaled(n_layers=4, n_encoder_layers=4), 2, cfg.n_layers)
    return cfg.scaled(n_layers=2), cfg.scaled(n_layers=4), 2, cfg.n_layers


def probe(arch: str, shape_name: str, out_dir: str | None = None) -> dict:
    """The roofline terms of one single-pod cell (module docstring)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    cell = {"arch": arch, "shape": shape_name, "chips": CHIPS}
    ok, reason = applicable(cfg, shape)
    if not ok:
        cell.update(status="skipped", reason=reason)
        return cell
    t0 = perf_counter()
    c = count_cell(cfg, shape, multi_pod=False)
    flops, bytes_acc, wire = float(c.flops), float(c.bytes), c.collective_wire_bytes

    n_active = cfg.active_param_count() - cfg.vocab * cfg.d_model  # embed lookup free
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens

    compute_t = flops / PEAK_FLOPS
    memory_t = bytes_acc / HBM_BW
    collective_t = (c.wire_bytes_by_link["nvlink"] / NVLINK_BW
                    + c.wire_bytes_by_link["network"] / NETWORK_BW)
    bound = max(compute_t, memory_t, collective_t)
    dominant = ("compute" if bound == compute_t
                else "memory" if bound == memory_t else "collective")
    cell.update(
        status="ok",
        flops_per_device=flops,
        bytes_per_device=bytes_acc,
        collective_wire_bytes=wire,
        collective_wire_bytes_by_link=dict(c.wire_bytes_by_link),
        compute_term_s=compute_t,
        memory_term_s=memory_t,
        collective_term_s=collective_t,
        dominant=dominant,
        model_flops=model_flops,
        model_flops_per_device=model_flops / CHIPS,
        useful_compute_ratio=(model_flops / CHIPS) / max(flops, 1.0),
        roofline_fraction=(model_flops / CHIPS / PEAK_FLOPS) / max(bound, 1e-12),
        peak_bytes=c.peak_bytes,
        probe_wall_s=round(perf_counter() - t0, 1),
        hardware=HARDWARE,
        model_flops_source=MODEL_FLOPS_SOURCE,
        note=NOTE,
    )
    return cell


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default=None)
    parser.add_argument("--shape", default=None)
    parser.add_argument("--out", default=os.path.abspath(RESULTS_DEFAULT))
    args = parser.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape_name in shapes:
            cell = probe(arch, shape_name, args.out)
            with open(os.path.join(args.out, f"{arch}__{shape_name}.json"), "w") as f:
                json.dump(cell, f, indent=1)
            if cell["status"] == "ok":
                print(  # reprolint: disable=R008 the roofline's console output
                    f"[ok] {arch} × {shape_name}: "
                    f"C={cell['compute_term_s']*1e3:.2f}ms "
                    f"M={cell['memory_term_s']*1e3:.2f}ms "
                    f"X={cell['collective_term_s']*1e3:.2f}ms "
                    f"dom={cell['dominant']} "
                    f"useful={cell['useful_compute_ratio']:.2f} "
                    f"roofline={cell['roofline_fraction']:.3f} "
                    f"({cell['probe_wall_s']}s)",
                    flush=True,
                )
            else:
                print(f"[skip] {arch} × {shape_name}: {cell['reason']}", flush=True)  # reprolint: disable=R008 the roofline's console output


if __name__ == "__main__":
    main()
