"""The attention kernels' wrappers on the CPU: what they decide in Python
before a launch, and K5's split-KV arithmetic.

- the split plan of decode attention (K5) from (B, Hkv, T): every block
  resident at once, at most one per 64-key chunk, a serving batch
  filling the card;
- the head-row load plan K5 takes per lane (its width, and its number
  of loads past one load a lane), at every hd from 1 to 256, refused
  past 256;
- the (dtype, hd) -> kernel rule of flash attention (K6): bf16 at the
  multiples of 16 up to 128 on the tensor cores, float32 at the models'
  widths on the CUDA cores, every other width up to 256 on the any-width
  kernel, refused past 256;
- TMA's refusals: a base address or stride off 16 bytes, a strided head
  dim;
- a PyTorch mirror of K5's chunked partials and their log-sum-exp merge
  (empty chunks included), held against the plain version at 1e-6 in
  float32 (the sums run in another order);
- K5's cut of a group past 8 query heads into slices (Qwen3-MoE's 16:
  two slices of 8, each a block's share with its own partials; 32 and
  64: four and eight), the split plan over (KV head, slice), the
  refusal of a group below 1 and of hd past 256, the ceilings against
  ``csrc/decode_attention.cu``, and the mirror per slice held against
  the plain version at 1e-6.

Nothing here launches or builds a kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak

SMS = 132  # an H100's streaming multiprocessors


@pytest.mark.parametrize("b,hkv", [(4, 20), (4, 32), (1, 8), (64, 8), (1000, 1)])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 300, 1024, 2048, 2304, 8192, 100_000])
def test_split_plan_deals_every_chunk_to_a_resident_block(b, hkv, t):
    chunk, splits = dak.split_plan(b, hkv, t, SMS)
    assert chunk == dak.CHUNK
    assert 1 <= splits <= min(-(-t // chunk), dak.MAX_SPLITS)
    # all blocks resident at once, where one block per head fits
    assert b * hkv * splits <= max(dak.BLOCKS_PER_SM * SMS, b * hkv)


def test_split_plan_fills_the_card_at_the_serving_shape():
    """4 slots x 20 KV heads at 1024 positions, and one sequence of 8 KV
    heads over 8192: at least two blocks per SM, all resident."""
    assert dak.split_plan(4, 20, 1024, SMS) == (64, 6)
    assert 4 * 20 * 6 >= 2 * SMS
    _, splits = dak.split_plan(1, 8, 8192, SMS)
    assert 2 * SMS <= 8 * splits <= dak.BLOCKS_PER_SM * SMS


@pytest.mark.parametrize(
    "hd,itemsize,want",
    [(128, 2, 8), (96, 2, 8), (80, 2, 8), (16, 2, 8), (20, 2, 4), (30, 2, 2), (31, 2, 1),
     (128, 4, 4), (80, 4, 4), (30, 4, 2), (31, 4, 1), (33, 2, 1), (66, 2, 2),
     (136, 2, 4), (132, 4, 4), (256, 2, 4), (257, 2, None), (512, 4, None)],
)
def test_lane_width(hd, itemsize, want):
    assert dak.lane_width(hd, itemsize) == want


@pytest.mark.parametrize(
    "hd,itemsize,want",
    [(128, 2, (8, 1)), (96, 2, (8, 1)), (96, 4, (4, 1)), (33, 2, (1, 2)), (33, 4, (1, 2)),
     (256, 2, (4, 2)), (256, 4, (4, 2)), (255, 2, (1, 8)), (200, 2, (4, 2)),
     (250, 4, (2, 4)), (0, 2, None), (257, 4, None)],
)
def test_lane_plan_at_the_new_widths(hd, itemsize, want):
    assert dak.lane_plan(hd, itemsize) == want


@pytest.mark.parametrize("itemsize", [2, 4])
def test_lane_plan_covers_every_width_up_to_256(itemsize):
    """At every hd from 1 to 256 the plan is one the kernel compiles: a
    load of at most 16 bytes dividing hd, at most 8 elements a lane; one
    load a lane only up to hd 128 with the row on a power of two of at
    most 32 lanes, else the row on 32 lanes covered by nv loads."""
    for hd in range(1, dak.MAX_HEAD_DIM + 1):
        epl, nv = dak.lane_plan(hd, itemsize)
        assert hd % epl == 0 and epl * itemsize <= dak.VEC_BYTES, hd
        assert nv in (1, 2, 4, 8) and epl * nv <= dak.MAX_LANE_ELEMS, hd
        if nv == 1:
            assert hd <= dak.ONE_LOAD_HEAD_DIM and -(-hd // epl) <= 32, hd
        else:
            assert 32 * epl * (nv // 2) < hd <= 32 * epl * nv or (hd > 128 and nv == 2), hd
    assert dak.lane_plan(dak.MAX_HEAD_DIM + 1, itemsize) is None


def test_flash_attention_route_is_by_dtype():
    assert fak.route(torch.bfloat16, 128) == "tensor_core"
    assert fak.route(torch.float32, 128) == "cuda_core"
    with pytest.raises(TypeError):
        fak.route(torch.float16, 128)


def test_flash_attention_route_covers_every_width_up_to_256():
    """bf16 takes the tensor cores at every multiple of 16 up to 128,
    float32 the CUDA-core kernel at the models' widths, and every other
    width from 1 to 256 the any-width kernel; 0 and 257 are refused."""
    for hd in range(1, fak.MAX_HEAD_DIM + 1):
        want_bf16 = "tensor_core" if hd % 16 == 0 and hd <= 128 else "any_width"
        want_f32 = "cuda_core" if hd in (16, 32, 64, 80, 128) else "any_width"
        assert fak.route(torch.bfloat16, hd) == want_bf16, hd
        assert fak.route(torch.float32, hd) == want_f32, hd
    assert fak.TC_HEAD_DIMS == tuple(range(16, 129, 16))
    for hd in (0, fak.MAX_HEAD_DIM + 1):
        with pytest.raises(ValueError, match="hd from 1 to 256"):
            fak.route(torch.bfloat16, hd)


def test_flash_attention_sources_compile_every_routed_width():
    """The C dispatch of each route names the widths the wrapper sends it."""
    src = (Path(fak.__file__).parent / "csrc" / "flash_attention.cu").read_text()

    def cases(macro):
        body = src[src.index(f"#define {macro}"):]
        body = body[: body.index("default:")]
        return tuple(int(w) for w in re.findall(r"case (\d+):", body))

    assert cases("FA_DISPATCH_TC") == fak.TC_HEAD_DIMS
    assert cases("FA_DISPATCH_CC") == fak.HEAD_DIMS
    assert int(re.search(r"constexpr int kMaxHeadDim = (\d+);",
                         src[src.index("namespace anyw"):]).group(1)) == fak.MAX_HEAD_DIM


def test_flash_attention_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    fak.reset_counts()
    fak.flash_attention(q, k, v)
    assert fak.COUNTS == {"flash_attention": 0, "tensor_core": 0, "plain": 1}


def test_tma_strides_of_dense_and_transposed_tensors():
    x = torch.zeros(2, 4, 50, 128, dtype=torch.bfloat16)
    assert fak.tma_strides("q", x) == (4 * 50 * 128, 50 * 128, 128)
    y = torch.zeros(2, 50, 12, 80, dtype=torch.bfloat16)[:, :, :4]  # a slice of wider rows
    assert fak.tma_strides("q", y.transpose(1, 2)) == (50 * 12 * 80, 80, 12 * 80)


def test_tma_strides_fill_dims_of_length_one():
    """A dimension of length 1 is never stepped over: it gets the dense
    stride whatever its own."""
    x = torch.zeros(64, dtype=torch.bfloat16).as_strided((1, 1, 4, 16), (3, 5, 16, 1))
    assert fak.tma_strides("k", x) == (64, 64, 16)


def test_tma_strides_refuse_what_tma_cannot_read():
    flat = torch.zeros(2 * 4 * 64 * 64 + 8, dtype=torch.bfloat16)
    base = flat.data_ptr() % fak.TMA_BYTES
    start = (fak.TMA_BYTES - base) // 2 % 8  # the first 16-byte aligned element
    aligned = flat[start : start + 2 * 4 * 64 * 64].view(2, 4, 64, 64)
    fak.tma_strides("q", aligned)  # aligned: taken
    off = flat[start + 1 : start + 1 + 2 * 4 * 64 * 64].view(2, 4, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        fak.tma_strides("q", off)
    wide = torch.zeros(2, 4, 64, 68, dtype=torch.bfloat16)[..., :64]  # 136-byte rows
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        fak.tma_strides("k", wide)
    with pytest.raises(ValueError, match="contiguous"):
        fak.tma_strides("v", torch.zeros(2, 4, 128, 64, dtype=torch.bfloat16).transpose(2, 3))


def _split_kv_mirror(q, k, v, pos, splits=None):
    """K5's arithmetic in PyTorch: the 64-key chunks of ``split_plan``
    dealt round-robin to the splits; per split the partial (m, l, acc)
    over its keys t <= pos (an empty split gives m = -inf, l = 0,
    acc = 0), then the splits merged by log-sum-exp; 0 where no key takes
    part."""
    b, h, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    chunk, planned = dak.split_plan(b, hkv, t, SMS)
    splits = splits or planned
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd) * hd**-0.5
    last = torch.minimum(pos, torch.tensor(t - 1))
    ms, ls, accs = [], [], []
    for s in range(splits):
        keys = torch.arange(t)
        keys = keys[(keys // chunk) % splits == s]
        logits = torch.einsum("bngh,bnth->bngt", qg, k[:, :, keys])
        valid = (keys[None, :] <= last[:, None])[:, None, None, :]
        logits = torch.where(valid, logits, -torch.inf)
        m = logits.amax(-1)
        p = torch.where(valid, torch.exp(logits - m.clamp(min=-1e30)[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bngt,bnth->bngh", p, v[:, :, keys]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    top = m.amax(0)
    w = torch.where(m == -torch.inf, 0.0, torch.exp(m - top.clamp(min=-1e30)))
    total = (w * l).sum(0)
    out = (w[..., None] * acc).sum(0) / torch.where(total > 0, total, 1.0)[..., None]
    return out.reshape(b, h, hd)


@pytest.mark.parametrize(
    "b,h,hkv,t,hd",
    [(4, 8, 8, 1024, 64), (2, 16, 2, 300, 32), (1, 8, 1, 4100, 16), (3, 4, 4, 130, 8),
     (8, 160, 20, 3000, 16)],
)
def test_split_kv_mirror_matches_the_plain_version(b, h, hkv, t, hd):
    rng = np.random.default_rng(t + hd)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    chunk, splits = dak.split_plan(b, hkv, t, SMS)
    assert splits > 1
    # pos 0 (every split but the first empty), on and past a chunk
    # boundary, past the first round of chunks, the last key, past the
    # cache
    for pos in ([0] * b, [chunk - 1] * b, [chunk] * b, [splits * chunk + 1] * b,
                [t - 1] * b, [t + 7] * b, rng.integers(0, t, b).tolist()):
        p = torch.tensor(pos, dtype=torch.int32)
        np.testing.assert_allclose(_split_kv_mirror(q, k, v, p),
                                   dak.decode_attention_plain(q, k, v, p), atol=1e-6,
                                   err_msg=str(pos))


def test_split_kv_mirror_gives_zero_without_keys():
    """pos < 0: every chunk is empty and the kernel's result is 0."""
    q, k, v = torch.ones(1, 2, 8), torch.ones(1, 2, 100, 8), torch.ones(1, 2, 100, 8)
    out = _split_kv_mirror(q, k, v, torch.tensor([-1], dtype=torch.int32))
    assert torch.equal(out, torch.zeros(1, 2, 8))


@pytest.mark.parametrize(
    "group,want",
    [(1, (1, 1)), (4, (1, 4)), (8, (1, 8)), (9, (2, 5)), (12, (2, 6)), (16, (2, 8)),
     (17, (3, 6)), (32, (4, 8)), (64, (8, 8)), (100, (13, 8))],
)
def test_group_slices_cut_past_eight_heads(group, want):
    n_slices, slice_heads = dak.group_slices(group)
    assert (n_slices, slice_heads) == want
    assert slice_heads <= dak.MAX_SLICE
    assert (n_slices - 1) * slice_heads < group <= n_slices * slice_heads


@pytest.mark.parametrize("group,hd", [(0, 128), (-1, 128), (4, 257), (32, 512)])
def test_groups_past_the_ceiling_are_refused(group, hd):
    """K5's remaining ceilings: a group below 1 query head per KV head,
    and a head row past 256."""
    if group < 1:
        with pytest.raises(ValueError, match="query head per KV head"):
            dak.group_slices(group)
        with pytest.raises(ValueError, match="query head per KV head"):
            dak.split_plan(4, 4, 1024, SMS, group)
    else:
        assert dak.group_slices(group)[1] <= dak.MAX_SLICE
        assert dak.lane_plan(hd, 2) is None and dak.lane_plan(hd, 4) is None


def test_the_ceilings_equal_the_kernel_source():
    src = (Path(dak.__file__).parent / "csrc" / "decode_attention.cu").read_text()

    def constexpr(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert constexpr("kMaxHeadDim") == dak.MAX_HEAD_DIM == 256
    assert constexpr("kOneLoadHeadDim") == dak.ONE_LOAD_HEAD_DIM == 128
    assert constexpr("kMaxLaneElems") == dak.MAX_LANE_ELEMS == 8
    assert constexpr("kMaxSlice") == dak.MAX_SLICE == 8
    assert "kMaxGroup" not in src  # the number of slices grows with the group
    assert constexpr("kMaxSplits") == dak.MAX_SPLITS


def test_split_plan_counts_the_slices():
    """Groups up to 8 keep the plan they had; Qwen3-MoE's 4 slots x 4 KV
    heads x 2 slices over 1024 positions take 16 splits, 512 blocks."""
    for group in range(1, 9):
        assert dak.split_plan(4, 20, 1024, SMS, group) == dak.split_plan(4, 20, 1024, SMS)
    assert dak.split_plan(4, 4, 1024, SMS, 16) == (64, 16)
    assert dak.split_plan(4, 4, 1024, SMS, 8) == (64, 16)  # the chunks bound it
    _, splits = dak.split_plan(4, 4, 8192, SMS, 16)
    assert 4 * 4 * 2 * splits <= dak.BLOCKS_PER_SM * SMS < 4 * 4 * 2 * (splits + 1)


def test_split_plan_at_groups_32_and_64():
    """A group of 32 (128 query / 4 KV heads, 4 slices) at 4 x 1024: 64
    blocks per split, 8 splits; a group of 64 over one KV head (8
    slices) at 2 x 1024: 16 blocks per split, one per chunk."""
    assert dak.group_slices(32) == (4, 8)
    assert dak.split_plan(4, 4, 1024, SMS, 32) == (64, 8)
    assert 4 * 4 * 4 * 8 <= dak.BLOCKS_PER_SM * SMS
    assert dak.group_slices(64) == (8, 8)
    assert dak.split_plan(2, 1, 1024, SMS, 64) == (64, 16)


def _sliced_mirror(q, k, v, pos):
    """The kernel at a group past 8: each slice of ``group_slices`` served
    by its own blocks (the split plan over (KV head, slice)), with its own
    partials and merge, written to its heads of the output."""
    b, h, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    n_slices, width = dak.group_slices(g)
    _, splits = dak.split_plan(b, hkv, t, SMS, g)
    qg = q.reshape(b, hkv, g, hd)
    out = torch.empty_like(qg)
    for sl in range(n_slices):
        heads = slice(sl * width, min(g, (sl + 1) * width))
        part = qg[:, :, heads].reshape(b, -1, hd)
        got = _split_kv_mirror(part, k, v, pos, splits)
        out[:, :, heads] = got.reshape(b, hkv, -1, hd)
    return out.reshape(b, h, hd)


@pytest.mark.parametrize(
    "b,h,hkv,t,hd",
    [(4, 64, 4, 1024, 32), (2, 12, 1, 300, 16), (1, 16, 1, 4100, 8), (3, 36, 4, 130, 8)],
)
def test_sliced_mirror_matches_the_plain_version(b, h, hkv, t, hd):
    """Qwen3-MoE's layout (64 query / 4 KV heads: group 16, two slices)
    and groups 12 and 9 (slices of 6 and 5 + 4)."""
    rng = np.random.default_rng(h + t)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    chunk, splits = dak.split_plan(b, hkv, t, SMS, h // hkv)
    assert dak.group_slices(h // hkv)[0] == 2
    _check_sliced_mirror(q, k, v, chunk, splits, t, rng)


@pytest.mark.parametrize("b,h,hkv,t,hd", [(2, 128, 4, 700, 8), (1, 64, 1, 300, 33)])
def test_sliced_mirror_matches_the_plain_version_at_groups_32_and_64(b, h, hkv, t, hd):
    """Four and eight slices of 8 heads, each with its own partials."""
    rng = np.random.default_rng(h + t)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    chunk, splits = dak.split_plan(b, hkv, t, SMS, h // hkv)
    assert dak.group_slices(h // hkv)[0] == h // hkv // 8
    _check_sliced_mirror(q, k, v, chunk, splits, t, rng)


def _check_sliced_mirror(q, k, v, chunk, splits, t, rng):
    b = q.shape[0]
    for pos in ([0] * b, [chunk] * b, [splits * chunk + 1] * b, [t - 1] * b, [t + 7] * b,
                rng.integers(0, t, b).tolist()):
        p = torch.tensor(pos, dtype=torch.int32)
        np.testing.assert_allclose(_sliced_mirror(q, k, v, p),
                                   dak.decode_attention_plain(q, k, v, p), atol=1e-6,
                                   err_msg=str(pos))


def test_decode_attention_cpu_tensors_take_the_plain_version_at_any_group():
    """The plain version has no ceiling: a CPU tensor at any group is
    computed, never refused."""
    q, k, v = torch.ones(1, 32, 8), torch.ones(1, 1, 10, 8), torch.ones(1, 1, 10, 8)
    dak.reset_counts()
    out = dak.decode_attention(q, k, v, torch.tensor([3], dtype=torch.int32))
    assert dak.COUNTS == {"decode_attention": 0, "plain": 1}
    assert torch.equal(out, torch.ones(1, 32, 8))


def test_contracts_declare_the_256_ceiling():
    """The kernelcheck contracts of K5 and K6: every width up to 256 goes
    to a kernel on the card, 257 is refused there, the CPU takes the plain
    version at any width; the blocks fit the card's opt-in shared memory
    (K6's tensor-core block at hd 128 is the source's Tile<128>::kSmem,
    the any-width block at 256 the fp32 tiles of hd + 1)."""
    from repro_torch.analysis.contracts import CONTRACTS

    k5, k6 = CONTRACTS["decode_attention.kernel"], CONTRACTS["flash_attention.kernel"]
    for dtype in ("float32", "bfloat16"):
        for hd, want in ((1, "cuda"), (33, "cuda"), (256, "cuda"), (257, "refused")):
            geom = {"hd": hd, "group": 32, "dtype": dtype, "device": "cuda"}
            assert k5.dispatch(geom) == want
        assert k5.dispatch({"hd": 512, "group": 64, "dtype": dtype, "device": "cpu"}) == "plain"
        assert k6.dispatch({"hd": 72, "dtype": dtype, "device": "cuda"}) == "any_width"
        assert k6.dispatch({"hd": 257, "dtype": dtype, "device": "cuda"}) == "refused"
        for hd in (1, 96, 128, 256):
            assert k6.smem({"hd": hd, "dtype": dtype, "device": "cuda"}).smem_bytes <= 227 * 1024
    assert k6.dispatch({"hd": 96, "dtype": "bfloat16", "device": "cuda"}) == "tensor_core"
    assert fak.launch_config("tensor_core", 128).dynamic_smem == 230_456
    assert fak.launch_config("any_width", 256).dynamic_smem == 213_760
    assert k5.smem({"hd": 256, "group": 32, "dtype": "float32",
                    "device": "cuda"}).static_smem == 4 * 4 * 8 * (2 + 256) + 4
