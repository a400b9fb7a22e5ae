"""The port's dry run (``launch/dryrun.py``, ``launch/roofline.py``) and
the count rules of K4-K7, on the CPU.

- Each kernel's operation and byte counts equal a hand count on two
  shapes, through its wrapper on ``meta`` inside the counting scope (the
  shape rule's outputs checked too): K6 causal and not, on both tile
  sizes; K5 with ``pos`` short of the cache counts as with ``pos`` at
  its end (the CPU wrapper, which reads ``pos``, adds the same count).
- A ``meta`` tensor given to a wrapper outside the counting scope
  raises, as a tensor on a device other than ``cpu``, ``cuda`` and
  ``meta`` does; a CPU tensor still takes the plain version.
- The memory tracker's peak and the byte counter equal a hand count on
  a known sequence of allocations, views and frees.
- The train, prefill and decode steps of every arch's 2-layer smoke
  config count the same FLOPs, kernel calls, bytes moved and memory
  (arguments, temporaries, outputs) on ``meta`` and on the CPU.
- In fake worlds of 256 / 512 ranks, in two subprocesses with their own
  timeout, started with the module's first test and run beside the
  in-process tests (``tests/torch_dryrun_cases.py``): the production meshes and
  the collectives the dry run relies on (torch's ``fake_pg`` is
  internal, so its behaviour is pinned here); a small train cell's
  collectives equal a hand count from the sharded step's code, the same
  at rank 0 and rank 255; counts linear in depth (4 layers less 2 equal
  twice one layer within 0.1 %); Qwen1.5-4B ``decode_32k`` at full size
  written with the reference's keys, and DeepSeek-V3 ``train_4k`` not
  fitting.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import _tensors
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.launch import dryrun, specs
from repro_torch.parallel import AbstractMesh, param_sharding
from repro_torch.train import AdamWConfig

import torch_dryrun_cases as cases

META = torch.device("meta")
BF16, F32 = torch.bfloat16, torch.float32
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "status", "flops_per_device",
                  "bytes_per_device", "argument_bytes", "output_bytes", "temp_bytes",
                  "collective_ops", "collective_operand_bytes", "collective_wire_bytes"}
PORT_KEYS = {"strategy", "peak_bytes", "hbm_bytes", "fits", "rank", "count_wall_s"}


def _counted(fn, *args, **kwargs):
    with _tensors.counting() as counts:
        out = fn(*args, **kwargs)
    (row,) = counts.by_kernel.values()
    return out, row


def _meta(*shape, dtype=BF16):
    return torch.empty(*shape, dtype=dtype, device=META)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The fake-world tasks, started with the module's first test so that
    they run beside the in-process tests: the DeepSeek-V3 cell alone,
    the rest together."""
    tasks = {"world+cells": cases.Started(tmp_path_factory.mktemp("cells"), "world", "cells",
                                          timeout=300),
             "deepseek": cases.Started(tmp_path_factory.mktemp("deepseek"), "deepseek",
                                       timeout=300)}
    yield tasks
    for task in tasks.values():
        task.stop()


# ---- the kernels' count rules ------------------------------------------------------


@pytest.mark.parametrize("rows, d, dtype, blocks", [
    (8, 2560, BF16, 8),  # a decode step's rows: a block a row
    (8192, 2560, BF16, 1024),  # a prefill's rows: 8 rows a block, under 8 blocks an SM
    (40000, 1024, F32, 8 * 132),  # past the grid's cap
])
def test_rmsnorm_counts_equal_hand_counts(rows, d, dtype, blocks):
    x, g = _meta(rows, d, dtype=dtype), _meta(d, dtype=dtype)
    y, row = _counted(rnk.rmsnorm, x, g)
    elt = dtype.itemsize
    assert row == {"calls": 1, "ops": 4 * rows * d, "bytes": (2 * rows * d + blocks * d) * elt}
    assert y.device == META and y.shape == x.shape and y.dtype == dtype


@pytest.mark.parametrize("b, h, hkv, t, hd, slices, splits, slice_heads", [
    (4, 20, 20, 1024, 128, 1, 6, 1),  # Qwen1.5-4B: 80 blocks, 6 splits fill 132 SMs
    (4, 64, 4, 1024, 128, 2, 16, 8),  # Qwen3-MoE: a group of 16 in two slices
])
def test_decode_attention_counts_equal_hand_counts(b, h, hkv, t, hd, slices, splits,
                                                   slice_heads):
    q, k = _meta(b, h, hd), _meta(b, hkv, t, hd)
    pos = torch.empty(b, dtype=torch.int32, device=META)
    out, row = _counted(dak.decode_attention, q, k, k, pos)
    partial_rows = b * hkv * slices * splits * slice_heads
    want = (2 * b * h * hd * 2 + 2 * b * hkv * t * hd * 2 * slices
            + 2 * partial_rows * (hd + 2) * 4 + 4 * b)
    assert row == {"calls": 1, "ops": 4 * b * h * t * hd, "bytes": want}
    assert out.device == META and out.shape == q.shape


def test_decode_attention_count_reads_no_pos():
    """On the CPU (where ``pos`` has values) the count is the same with
    ``pos`` short of the cache as at its end: an upper bound."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 64, generator=gen)
    k, v = torch.randn(2, 2, 300, 64, generator=gen), torch.randn(2, 2, 300, 64, generator=gen)
    rows = []
    for p in (5, 299):
        pos = torch.full((2,), p, dtype=torch.int32)
        out, row = _counted(dak.decode_attention, q, k, v, pos)
        torch.testing.assert_close(out, dak.decode_attention_plain(q, k, v, pos))
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[0]["ops"] == 4 * 2 * 8 * 300 * 64


@pytest.mark.parametrize("s, t, hd, dtype, causal, pairs, keys", [
    # the tensor cores: 128-row query tiles, 128-key tiles
    (256, 256, 128, BF16, False, 256 * 256, 2 * 256),
    (256, 256, 128, BF16, True, 128 * 128 + 128 * 256, 128 + 256),
    # (300 rows: tiles of 128, 128, 44; the last sees up to key 299)
    (300, 300, 128, BF16, True, 128 * 128 + 128 * 256 + 44 * 300, 128 + 256 + 300),
    # the CUDA cores: 64-row query tiles, 64-key tiles, the bound at the
    # tile's last row even past S
    (100, 100, 64, F32, True, 64 * 64 + 36 * 100, 64 + 100),
    (100, 1500, 64, F32, False, 100 * 1500, 2 * 1500),
])
def test_flash_attention_counts_equal_hand_counts(s, t, hd, dtype, causal, pairs, keys):
    b, h, hkv = 2, 4, 2
    q, k = _meta(b, h, s, hd, dtype=dtype), _meta(b, hkv, t, hd, dtype=dtype)
    out, row = _counted(fak.flash_attention, q, k, k, causal=causal)
    elt = dtype.itemsize
    assert row == {"calls": 1, "ops": 4 * b * h * hd * pairs,
                   "bytes": (2 * b * h * s * hd + 2 * b * h * keys * hd) * elt}
    assert out.device == META and out.shape == q.shape and out.stride() == q.stride()


def test_flash_attention_meta_path_makes_the_launchs_checks():
    q = _meta(1, 2, 8, 300)
    with pytest.raises(ValueError, match="hd from 1 to 256"):
        _counted(fak.flash_attention, q, q[:, :1], q[:, :1])
    with pytest.raises(TypeError):
        _counted(fak.flash_attention, _meta(1, 2, 8, 64), _meta(1, 1, 8, 64, dtype=F32),
                 _meta(1, 1, 8, 64))
    x = _meta(1, 8, 2, 64).transpose(1, 2)  # the model's strided view: taken
    _, row = _counted(fak.flash_attention, x, x, x)
    assert row["calls"] == 1


@pytest.mark.parametrize("b, s, h, p, n, dtype", [
    (4, 2048, 24, 64, 128, BF16),  # Mamba2-130M's prefill
    (1, 100, 2, 16, 16, F32),  # a ragged last chunk, the CUDA cores
])
def test_ssd_scan_counts_equal_hand_counts(b, s, h, p, n, dtype):
    x = _meta(b, s, h, p, dtype=dtype)
    dt, a = _meta(b, s, h, dtype=F32), _meta(h, dtype=F32)
    bm = _meta(b, s, n, dtype=dtype)
    (y, h_last), row = _counted(ssk.ssd_scan, x, dt, a, bm, bm)
    chunks, q, elt = -(-s // 64), 64, dtype.itemsize
    ops = b * chunks * (2 * q * q * n + h * (2 * q * q * p + 2 * q * p * n + 2 * q * n * p))
    once = (b * s * h * p * elt + b * s * h * 4 + 2 * b * s * n * elt + 4 * h
            + 4 * b * s * h * p + 4 * b * h * p * n)
    if dtype == BF16:  # two launches: x, dt and B read again; the scratch written and read
        once += b * s * h * p * elt + b * s * h * 4 + b * s * n * elt + 2 * 4 * b * chunks * h * p * n
    assert row == {"calls": 1, "ops": ops, "bytes": once}
    assert y.shape == (b, s, h, p) and y.dtype == F32 and h_last.shape == (b, h, p, n)


def test_meta_outside_the_counting_scope_raises():
    q = _meta(1, 2, 8, 64)
    for call in (lambda: rnk.rmsnorm(_meta(4, 64), _meta(64)),
                 lambda: fak.flash_attention(q, q, q),
                 lambda: dak.decode_attention(_meta(1, 2, 64), q, q,
                                              torch.empty(1, dtype=torch.int32, device=META)),
                 lambda: ssk.ssd_scan(_meta(1, 8, 2, 16, dtype=F32), _meta(1, 8, 2, dtype=F32),
                                      _meta(2, dtype=F32), _meta(1, 8, 16, dtype=F32),
                                      _meta(1, 8, 16, dtype=F32))):
        with pytest.raises(ValueError, match="only inside a counting scope"):
            call()
    other = SimpleNamespace(device=torch.device("xpu"))
    for scope in (_tensors.counting(), torch.no_grad()):
        with scope, pytest.raises(ValueError, match="unsupported device xpu"):
            _tensors.check_device("rmsnorm", other, other)
    with _tensors.counting():
        assert _tensors.check_device("rmsnorm", _meta(2)) == "meta"
    assert _tensors.check_device("rmsnorm", torch.zeros(2)) == "cpu"


def test_cpu_tensors_take_the_plain_version_inside_and_outside_the_scope():
    gen = torch.Generator().manual_seed(1)
    x, g = torch.randn(6, 32, generator=gen), torch.randn(32, generator=gen)
    rnk.reset_counts()
    want = rnk.rmsnorm(x, g)
    got, row = _counted(rnk.rmsnorm, x, g)
    assert torch.equal(got, want) and rnk.COUNTS == {"rmsnorm": 0, "plain": 2}
    assert row["ops"] == rnk.op_count(6, 32)


# ---- the memory tracker and the byte counter ----------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_memory_tracker_peak_equals_a_hand_count(device):
    def step(x):
        a = x * 2  # 4,000 live
        b = torch.empty(2000, device=x.device)  # 12,000
        del a  # 8,000
        c = b[:10]  # a view: nothing new
        d = b + 1  # 16,000: the peak
        x.add_(1)  # in place on an argument: nothing new
        del b, d  # b's storage lives on in c: 8,000
        e = torch.zeros(500, device=x.device)  # 10,000
        return c, e

    x = torch.zeros(1000, device=device)
    (c, e), counts = dryrun.count_step(step, (x,), device=device)
    assert counts.argument_bytes == 4000
    assert counts.temp_bytes == 16000
    assert counts.peak_bytes == 20000
    assert counts.output_bytes == 8000 + 2000
    # moved: x * 2 (4,000 in + 4,000 out), b + 1 (8,000 + 8,000), add_
    # (4,000 read + 4,000 written), zeros' fill (2,000 written)
    assert counts.bytes == 8000 + 16000 + 8000 + 2000
    assert counts.flops == 0 and counts.collective_ops == {}


# ---- meta against the CPU at 2 layers ------------------------------------------------


def _fill(args, kind):
    gen = torch.Generator().manual_seed(0)
    params = args[0]["params"] if kind == "train" else args[0]
    with torch.no_grad():
        for t in dryrun._tensors(params):
            t.copy_(torch.randn(t.shape, generator=gen) * 0.05)


@pytest.fixture
def one_thread():
    """One intra-op thread for the CPU steps (tiny shapes, run beside the
    fake-world subprocesses), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_are_the_same_on_meta_and_on_the_cpu(arch, kind, one_thread):
    cfg = get_smoke_config(arch)
    layers = 2 * cfg.hybrid_period if cfg.block_pattern == "zamba2" else 2
    cfg = cfg.scaled(n_layers=layers, n_encoder_layers=min(2, cfg.n_encoder_layers))
    shape = ShapeSpec(f"two_layers_{kind}", kind, 24, 2)
    counts = {}
    for device in ("meta", "cpu"):
        fn, args = specs.step_fn_for(cfg, shape, AdamWConfig(), device=device)
        if device == "cpu":
            _fill(args, kind)
        out, counts[device] = dryrun.count_step(fn, args, device=device)
    meta, cpu = counts["meta"], counts["cpu"]
    assert meta.flops == cpu.flops > 0
    assert {k: v["calls"] for k, v in meta.kernels.items()} == \
        {k: v["calls"] for k, v in cpu.kernels.items()}
    assert meta.argument_bytes == cpu.argument_bytes
    assert (meta.temp_bytes, meta.output_bytes, meta.bytes) == \
        (cpu.temp_bytes, cpu.output_bytes, cpu.bytes)
    assert meta.temp_bytes > 0


# ---- fake worlds of 256 and 512 ranks, in subprocesses -------------------------------


@pytest.fixture(scope="module")
def world(started):
    return started["world+cells"].result()["world"]


@pytest.fixture(scope="module")
def cells(started):
    out = started["world+cells"]
    return out.result()["cells"], out.out.parent / "dryrun"


@pytest.fixture(scope="module")
def deepseek(started):
    return started["deepseek"].result()["deepseek"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_the_fake_world_builds_the_production_meshes(world, mesh):
    w = world[mesh]
    if mesh == "single":
        assert (w["shape"], w["names"], w["world"]) == ([16, 16], ["data", "model"], 256)
        assert w["coordinate"] == [15, 15]  # rank 255, rank-major
        assert w["full"] == [64 * 16, 32 * 16]
    else:
        assert (w["shape"], w["names"], w["world"]) == ([2, 16, 16], ["pod", "data", "model"],
                                                        512)
        assert w["coordinate"] == [1, 15, 15]
        assert w["full"] == [64 * 32, 32 * 16]
    assert w["full_device"] == "meta"
    # one gather per sharded mesh axis and the explicit all-reduce, counted
    assert w["comm_total"] == len(w["shape"]) + 1
    assert w["comm"] == {"c10d_functional.all_gather_into_tensor": len(w["shape"]),
                         "c10d.allreduce_": 1}


def test_small_train_cell_collectives_equal_a_hand_count(cells):
    """Qwen1.5-4B at full width, 2 layers, 16 x 64 tokens on (16, 16),
    counted from ``train/step.py``'s sharded step: one gather per sharded
    mesh axis of each parameter; one reduction of each gradient over
    ``data`` (a reduce-scatter where the parameter is sharded on ``data``,
    else an all-reduce; ``model`` needs none: replicated gradients become
    its blocks locally); the norm's all-reduce over each mesh axis; the
    cross-entropy's over ``data``."""
    counts, _ = cells
    cfg = get_config("qwen1.5-4b").scaled(n_layers=2)
    rules = param_sharding(AbstractMesh((16, 16), ("data", "model")),
                           specs.param_specs(cfg))
    gathers = on_data = n = 0
    stack = [rules]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
            continue
        n += 1
        axes = {a for entry in node if entry for a in
                ((entry,) if isinstance(entry, str) else entry)}
        gathers += len(axes)
        on_data += "data" in axes
    want = {"all-gather": gathers, "reduce-scatter": on_data,
            "all-reduce": (n - on_data) + 2 + 1}
    assert counts["small_train/0"]["ops"] == want
    assert gathers > 0 and on_data > 0


def test_rank_0_and_rank_255_count_the_same(cells):
    counts, _ = cells
    assert counts["small_train/0"] == counts["small_train/255"]
    by_link = counts["small_train/0"]["by_link"]
    assert by_link["nvlink"] == 0 and by_link["network"] > 0  # both axes span nodes


def test_counts_are_linear_in_depth(cells):
    counts, _ = cells
    lo, mid, hi = (counts[f"depth/{k}"] for k in ("lo", "mid", "hi"))
    assert (lo["layers"], mid["layers"], hi["layers"]) == (2, 3, 4)
    for key in ("flops", "bytes", "wire"):
        per_layer = mid[key] - lo[key]
        assert per_layer > 0, key
        assert abs((hi[key] - lo[key]) - 2 * per_layer) <= 1e-3 * (hi[key] - lo[key]), key


def test_full_size_cells_write_the_references_keys(cells, deepseek):
    counts, out_dir = cells
    cell = counts["cell/qwen1.5-4b/decode_32k"]
    assert cell["status"] == "ok", cell
    assert REFERENCE_KEYS | PORT_KEYS <= set(cell)
    assert not {"lower_s", "compile_s"} & set(cell)
    assert cell["strategy"] == "gathered" and cell["rank"] == 0
    assert cell["chips"] == 256 and cell["mesh"] == "pod16x16"
    assert cell["peak_bytes"] == cell["argument_bytes"] + cell["temp_bytes"]
    assert cell["hbm_bytes"] == dryrun.HBM_BYTES
    assert cell["fits"] == (cell["peak_bytes"] <= dryrun.HBM_BYTES)
    assert cell["flops_per_device"] > 0 and cell["collective_ops"]["all-gather"] > 0
    written = json.loads((out_dir / "qwen1.5-4b__decode_32k__pod16x16.json").read_text())
    assert written == cell
    ds = deepseek
    assert ds["status"] == "ok" and ds["fits"] is False
    # the gathered bf16 parameters alone pass the card's memory
    assert ds["temp_bytes"] > 2 * 671e9 > dryrun.HBM_BYTES
