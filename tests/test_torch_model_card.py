"""The model kernels (RMSNorm, decode and flash attention, the SSD scan)
against their plain versions, and the dense, MoE, MLA + MoE, Mamba2 and
Zamba2 models on the card against the CPU.  Decode attention also at
groups of 12 and 16 query heads per KV head (two slices of a group),
and past them (20, 32, 64); both attention kernels at head widths up to
256 (odd ones included) and refusing 257.  Flash attention runs bf16 on
the tensor cores (multiples of 16 up to 128), float32 on the CUDA cores,
and every other width on the any-width kernel; decode attention splits
the cache over blocks (split-KV) and merges in the same launch.  The
K4 / K6 / K7 autograd Functions' gradients on the card against autograd
through the plain versions.

Needs a CUDA device (the kernels have no CPU mode), so it skips
elsewhere; run it on a GPU machine with
``python -m pytest -m gpu tests/test_torch_model_card.py``.  It imports
only the port, so it runs where jax is not installed.  ``chip_smoke.py``
makes the same checks at the serving path's shapes.

Tolerances: 5e-5 for float32 (sums taken in another order); for
bfloat16 2e-2 plus one bfloat16 rounding step (2**-7 of the value),
since kernel and plain version round the same fp32 result and may land
on either side of a rounding boundary.  The SSD scan writes fp32 in
both dtypes and is held to 5e-5 + 3e-5 of its output's largest
magnitude: its plain version's prefix sums run over 256-row chunks, the
kernel's over 64-row tiles, and each decay factor carries an fp32 ulp of
|cum| (up to ~200 in a 256-row chunk).
"""

import numpy as np
import pytest
import torch

from repro_torch.backend import set_backend
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.models import decode_step, init_params, prefill

DTYPES = (torch.float32, torch.bfloat16)


def _tol(dtype) -> dict:
    if dtype == torch.bfloat16:
        return {"atol": 2e-2, "rtol": 2**-7}
    return {"atol": 5e-5, "rtol": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), err_msg=msg, **_tol(dtype)
    )


def _flash_counts(dtype, n=1) -> dict:
    """K6's counts after n launches: bf16 takes the tensor cores."""
    return {"flash_attention": n, "tensor_core": n if dtype == torch.bfloat16 else 0,
            "plain": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(0)
    for shape in ((4, 37, 512), (128, 256), (1, 1, 8192), (3, 5, 20, 128), (8, 2560),
                  (7, 1025), (2, 16)):
        x = _randn(rng, shape, dtype, card)
        g = _randn(rng, shape[-1:], dtype, card)
        rnk.reset_counts()
        got = rnk.rmsnorm(x, g, 1e-6)
        assert rnk.COUNTS == {"rmsnorm": 1, "plain": 0}
        _close(got, rnk.rmsnorm_plain(x, g, 1e-6), dtype, str(shape))


def _rmsnorm_case(rng, case, dtype, dev):
    """(x, g, expected route) of one K4 route case."""
    rows, d = {"decode": (8, 2560), "prefill": (8192, 2560), "d768": (4096, 768),
               "hd128": (2049 * 4, 128), "d-not-vector": (300, 2562),
               "unaligned": (300, 2560), "wide-f32": (64, 4096)}[case]
    g = _randn(rng, (d,), dtype, dev)
    if case == "unaligned":  # rows start one element past a 16-byte boundary
        x = _randn(rng, (rows * d + 1,), dtype, dev)[1:].view(rows, d)
    else:
        x = _randn(rng, (rows, d), dtype, dev)
    vector = case not in ("d-not-vector", "unaligned") and not (
        case == "wide-f32" and dtype == torch.float32)
    return x, g, "vector" if vector else "scalar"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "case", ["decode", "prefill", "d768", "hd128", "d-not-vector", "unaligned", "wide-f32"]
)
def test_rmsnorm_vector_and_scalar_routes_match_plain(card, case, dtype):
    """K4's 16-byte vector route (aligned rows, d a multiple of the
    vector) and its scalar route (unaligned rows, d off the vector, fp32
    rows past 20 vectors a lane) at the models' widths, decode and
    prefill rows."""
    rng = np.random.default_rng(len(case))
    x, g, want_route = _rmsnorm_case(rng, case, dtype, card)
    assert rnk.route(x, g) == want_route
    rnk.reset_counts()
    got = rnk.rmsnorm(x, g, 1e-6)
    assert rnk.COUNTS == {"rmsnorm": 1, "plain": 0}
    _close(got, rnk.rmsnorm_plain(x, g, 1e-6), dtype, case)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,hkv,t,hd",
    [(2, 4, 2, 1024, 64), (3, 8, 8, 512, 128), (1, 16, 4, 2048, 64),
     (4, 20, 20, 1000, 128), (1, 64, 8, 300, 128), (2, 4, 2, 37, 16), (2, 10, 2, 77, 96),
     # groups past 8: two slices of a group (12: 6 + 6; 16: 8 + 8, Qwen3-MoE's shape)
     (2, 24, 2, 700, 128), (3, 12, 1, 130, 64), (4, 64, 4, 1024, 128), (1, 16, 1, 8192, 128)],
)
def test_decode_attention_kernel_matches_plain(card, b, h, hkv, t, hd, dtype):
    rng = np.random.default_rng(b * 100 + t)
    q = _randn(rng, (b, h, hd), dtype, card)
    k = _randn(rng, (b, hkv, t, hd), dtype, card)
    v = _randn(rng, (b, hkv, t, hd), dtype, card)
    for pos in (rng.integers(0, t, b), np.zeros(b), np.full(b, t - 1), np.full(b, t + 5)):
        p = torch.tensor(pos, dtype=torch.int32, device=card)
        dak.reset_counts()
        got = dak.decode_attention(q, k, v, p)
        assert dak.COUNTS == {"decode_attention": 1, "plain": 0}
        _close(got, dak.decode_attention_plain(q, k, v, p), dtype, f"pos={pos}")


@pytest.mark.gpu
def test_decode_attention_kernel_ignores_keys_past_pos(card):
    rng = np.random.default_rng(1)
    q = _randn(rng, (1, 2, 64), torch.float32, card)
    k = _randn(rng, (1, 2, 1000, 64), torch.float32, card)
    v = _randn(rng, (1, 2, 1000, 64), torch.float32, card)
    pos = torch.tensor([100], dtype=torch.int32, device=card)
    out1 = dak.decode_attention(q, k, v, pos)
    k[:, :, 101:] = 1e4  # poison the dead region
    v[:, :, 101:] = -1e4
    out2 = dak.decode_attention(q, k, v, pos)
    assert torch.equal(out1, out2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,hkv,t,hd",
    [(4, 20, 20, 1024, 128), (1, 64, 8, 8192, 128), (2, 16, 2, 3000, 96), (3, 32, 32, 700, 80),
     (2, 8, 1, 64, 64), (1, 4, 4, 65, 16)],
)
def test_decode_attention_split_kv_edges(card, b, h, hkv, t, hd, dtype):
    """Positions on and around the chunk boundaries of ``split_plan``, pos
    0 (every split but the first empty), past the first round of chunks,
    pos past T, the last key, and the ticket counters back at 0 after
    each launch."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    chunk, splits = dak.split_plan(b, hkv, t, sms)
    rng = np.random.default_rng(t + hd)
    q = _randn(rng, (b, h, hd), dtype, card)
    k = _randn(rng, (b, hkv, t, hd), dtype, card)
    v = _randn(rng, (b, hkv, t, hd), dtype, card)
    edges = [0, chunk - 1, chunk, chunk + 1, splits * chunk - 1, splits * chunk,
             splits * chunk + 1, t - 1, t, t + 1000]
    for i in range(0, len(edges), b):
        pos = [edges[(i + j) % len(edges)] for j in range(b)]
        p = torch.tensor(pos, dtype=torch.int32, device=card)
        dak.reset_counts()
        got = dak.decode_attention(q, k, v, p)
        assert dak.COUNTS == {"decode_attention": 1, "plain": 0}
        _close(got, dak.decode_attention_plain(q, k, v, p), dtype, f"pos={pos}")
        assert int(dak._TICKETS[card.index or 0][: b * hkv].abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("group", [12, 16])
def test_decode_attention_sliced_group_ignores_keys_past_pos(card, group):
    """A group cut into two slices: the poisoned rows after pos change
    neither slice's heads, and every slice's ticket counter is back at 0."""
    rng = np.random.default_rng(group)
    b, hkv, t = 4, 4, 1024
    q = _randn(rng, (b, group * hkv, 128), torch.bfloat16, card)
    k = _randn(rng, (b, hkv, t, 128), torch.bfloat16, card)
    v = _randn(rng, (b, hkv, t, 128), torch.bfloat16, card)
    pos = torch.tensor([0, 63, 300, 1000], dtype=torch.int32, device=card)
    out1 = dak.decode_attention(q, k, v, pos)
    for i, at in enumerate(pos.tolist()):
        k[i, :, at + 1:] = 1e4
        v[i, :, at + 1:] = -1e4
    assert torch.equal(out1, dak.decode_attention(q, k, v, pos))
    _close(out1, dak.decode_attention_plain(q, k, v, pos), torch.bfloat16)
    n_slices, _ = dak.group_slices(group)
    assert int(dak._TICKETS[card.index or 0][: b * hkv * n_slices].abs().sum()) == 0


@pytest.mark.gpu
def test_decode_attention_split_kv_ignores_keys_past_pos(card):
    """bf16, pos past a split boundary: the poisoned rows after pos, in its
    own split and in the empty ones, change nothing."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (2, 8, 128), torch.bfloat16, card)
    k = _randn(rng, (2, 8, 1024, 128), torch.bfloat16, card)
    v = _randn(rng, (2, 8, 1024, 128), torch.bfloat16, card)
    pos = torch.tensor([100, 300], dtype=torch.int32, device=card)
    out1 = dak.decode_attention(q, k, v, pos)
    k[0, :, 101:] = 1e4
    v[0, :, 101:] = -1e4
    k[1, :, 301:] = 1e4
    v[1, :, 301:] = -1e4
    assert torch.equal(out1, dak.decode_attention(q, k, v, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,h,hkv,s,t,hd",
    [(2, 4, 2, 256, 256, 128), (1, 8, 8, 128, 128, 128), (2, 2, 1, 512, 512, 128),
     (1, 4, 2, 200, 200, 64), (2, 4, 4, 129, 129, 16), (1, 4, 1, 100, 300, 32),
     (1, 64, 8, 65, 65, 128), (1, 64, 4, 300, 300, 128)],  # Qwen3-MoE: 64 / 4 heads
)
def test_flash_attention_kernel_matches_plain(card, b, h, hkv, s, t, hd, dtype, causal):
    rng = np.random.default_rng(s * 10 + hd)
    q = _randn(rng, (b, h, s, hd), dtype, card)
    k = _randn(rng, (b, hkv, t, hd), dtype, card)
    v = _randn(rng, (b, hkv, t, hd), dtype, card)
    fak.reset_counts()
    got = fak.flash_attention(q, k, v, causal=causal)
    assert fak.COUNTS == _flash_counts(dtype)
    _close(got, fak.flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.gpu
def test_flash_attention_kernel_reads_strided_views(card):
    """The model's (B, S, H, hd) projections go in as transposed views."""
    rng = np.random.default_rng(2)
    b, s, h, hkv, hd = 2, 150, 4, 2, 64
    q = _randn(rng, (b, s, h, hd), torch.float32, card)
    k = _randn(rng, (b, s, hkv, hd), torch.float32, card)
    v = _randn(rng, (b, s, hkv, hd), torch.float32, card)
    got = fak.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.stride() == q.transpose(1, 2).stride()
    want = fak.flash_attention_plain(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
    )
    _close(got, want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", fak.HEAD_DIMS)
@pytest.mark.parametrize(
    "b,h,hkv,s,t",
    [(2, 4, 2, 256, 256), (1, 64, 8, 300, 300), (2, 3, 1, 129, 129), (1, 4, 4, 1, 1),
     (1, 8, 2, 100, 333), (1, 2, 2, 333, 100), (2, 32, 32, 2000, 2000)],
)
def test_flash_attention_tensor_cores_every_width(card, b, h, hkv, s, t, hd, causal):
    """bf16 on the tensor cores at every compiled head width: GQA groups
    up to 8, ragged S and T (T > S and T < S), one row."""
    rng = np.random.default_rng(s * 7 + t + hd)
    q = _randn(rng, (b, h, s, hd), torch.bfloat16, card)
    k = _randn(rng, (b, hkv, t, hd), torch.bfloat16, card)
    v = _randn(rng, (b, hkv, t, hd), torch.bfloat16, card)
    fak.reset_counts()
    got = fak.flash_attention(q, k, v, causal=causal)
    assert fak.COUNTS == _flash_counts(torch.bfloat16)
    _close(got, fak.flash_attention_plain(q, k, v, causal=causal), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [80, 128])
def test_flash_attention_tensor_cores_read_strided_views(card, hd):
    """bf16: the model's (B, S, H, hd) projections go in as transposed
    views, and q as a slice of a wider row, through the tensor maps."""
    rng = np.random.default_rng(6)
    b, s, h, hkv = 2, 300, 8, 2
    qkv = _randn(rng, (b, s, (h + 2 * hkv) * hd), torch.bfloat16, card)
    q = qkv[..., : h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd : (h + hkv) * hd].reshape(b, s, hkv, hd)
    v = qkv[..., (h + hkv) * hd :].reshape(b, s, hkv, hd)
    fak.reset_counts()
    got = fak.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert fak.COUNTS == _flash_counts(torch.bfloat16)
    want = fak.flash_attention_plain(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
    )
    _close(got, want, torch.bfloat16)


@pytest.mark.gpu
def test_flash_attention_tensor_cores_refuse_what_tma_cannot_read(card):
    """A base address or a stride off TMA's 16 bytes raises, with no copy
    and no launch."""
    flat = torch.zeros(2 * 4 * 64 * 64 + 1, dtype=torch.bfloat16, device=card)
    off = flat[1:].view(2, 4, 64, 64)  # 2 bytes past a 16-byte boundary
    ok = torch.zeros(2, 4, 64, 64, dtype=torch.bfloat16, device=card)
    wide = torch.zeros(2, 4, 64, 68, dtype=torch.bfloat16, device=card)[..., :64]
    fak.reset_counts()
    for q, k in ((off, ok), (ok, off), (ok, wide)):
        with pytest.raises(ValueError, match="TMA"):
            fak.flash_attention(q, k, ok)
    assert fak.COUNTS == {"flash_attention": 0, "tensor_core": 0, "plain": 0}


def _cache_leaves(cache: dict) -> list:
    out, todo = [], [cache["layers"]]
    while todo:
        node = todo.pop()
        for v in node.values():
            if isinstance(v, dict):
                todo.append(v)
            else:
                out.append(v.cpu())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,s,h,p,n",
    [(4, 2048, 24, 64, 128), (2, 2048, 80, 64, 64), (2, 200, 3, 16, 16), (1, 2000, 8, 64, 128),
     (3, 1, 4, 32, 32), (2, 129, 2, 16, 64), (1, 64, 2, 64, 16)],
)
def test_ssd_scan_kernel_matches_plain(card, b, s, h, p, n, dtype):
    rng = np.random.default_rng(s + n)
    x = _randn(rng, (b, s, h, p), dtype, card) * 0.5
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32, card))
    a = -torch.exp(_randn(rng, (h,), torch.float32, card) * 0.3)
    bm = _randn(rng, (b, s, n), dtype, card) * 0.5
    cm = _randn(rng, (b, s, n), dtype, card) * 0.5
    ssk.reset_counts()
    got = ssk.ssd_scan(x, dt, a, bm, cm, chunk=256)
    assert ssk.COUNTS == {"ssd_scan": 1, "tensor_core": int(dtype == torch.bfloat16),
                          "plain": 0}
    for g, w in zip(got, ssk.ssd_scan_plain(x, dt, a, bm, cm, 256)):
        assert g.dtype == torch.float32
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=5e-5 + 3e-5 * scale)


def _ssd_check(rng, card, b, s, h, p, n, dtype):
    x = _randn(rng, (b, s, h, p), dtype, card) * 0.5
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32, card))
    a = -torch.exp(_randn(rng, (h,), torch.float32, card) * 0.3)
    bm = _randn(rng, (b, s, n), dtype, card) * 0.5
    cm = _randn(rng, (b, s, n), dtype, card) * 0.5
    ssk.reset_counts()
    got = ssk.ssd_scan(x, dt, a, bm, cm, chunk=256)
    assert ssk.COUNTS["tensor_core"] == int(ssk.route(dtype) == "tensor_core")
    for g, w in zip(got, ssk.ssd_scan_plain(x, dt, a, bm, cm, 256)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=5e-5 + 3e-5 * scale, err_msg=str((b, s, h, p, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 63, 65, 2047])
def test_ssd_scan_kernel_ragged_lengths(card, s, dtype):
    """Chunks of 64 rows with a ragged last chunk, at both models' head
    layouts."""
    rng = np.random.default_rng(s)
    for h, n in ((24, 128), (80, 64)):
        _ssd_check(rng, card, 2, s, h, 64, n, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", ssk.HEAD_DIMS)
def test_ssd_scan_kernel_every_compiled_width(card, p, dtype):
    rng = np.random.default_rng(p)
    for n in ssk.STATE_DIMS:
        _ssd_check(rng, card, 2, 130, 5, p, n, dtype)


@pytest.mark.gpu
def test_ssd_scan_kernel_reads_strided_conv_slices(card):
    """The model's x, B and C are slices of one conv output."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 300, 24, 64, 128
    conv = _randn(rng, (b, s, h * p + 2 * n), torch.bfloat16, card)
    x = conv[..., : h * p].reshape(b, s, h, p)
    bm, cm = conv[..., h * p : h * p + n], conv[..., h * p + n :]
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32, card))
    a = -torch.exp(_randn(rng, (h,), torch.float32, card) * 0.3)
    got = ssk.ssd_scan(x, dt, a, bm, cm)
    want = ssk.ssd_scan_plain(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=5e-5 + 3e-5 * float(w.abs().max()))


@pytest.mark.gpu
def test_ssd_scan_kernel_reads_views_off_16_byte_alignment(card):
    """x, B and C one element past a 16-byte boundary, with odd row
    strides: the tensor-core route stages them element by element."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 2, 300, 6, 64, 128
    conv = _randn(rng, (b, s, h * p + 2 * n + 3), torch.bfloat16, card)
    x = conv[..., 1 : 1 + h * p].reshape(b, s, h, p)
    bm = conv[..., 1 + h * p : 1 + h * p + n]
    cm = conv[..., 1 + h * p + n : 1 + h * p + 2 * n]
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32, card))
    a = -torch.exp(_randn(rng, (h,), torch.float32, card) * 0.3)
    got = ssk.ssd_scan(x, dt, a, bm, cm)
    want = ssk.ssd_scan_plain(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=5e-5 + 3e-5 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_kernels_at_head_width_80(card, dtype):
    """Zamba2's heads: K6 causal over 2048 and a ragged 2000, K5 over a
    1024-position cache."""
    rng = np.random.default_rng(80)
    for b, h, s, causal in ((1, 32, 2048, True), (2, 32, 2000, True), (1, 32, 2000, False)):
        q, k, v = (_randn(rng, (b, h, s, 80), dtype, card) for _ in range(3))
        fak.reset_counts()
        got = fak.flash_attention(q, k, v, causal=causal)
        assert fak.COUNTS == _flash_counts(dtype)
        _close(got, fak.flash_attention_plain(q, k, v, causal=causal), dtype, str(s))
    q = _randn(rng, (4, 32, 80), dtype, card)
    k, v = (_randn(rng, (4, 32, 1024, 80), dtype, card) for _ in range(2))
    for pos in ([0, 5, 500, 1023], [1023] * 4, [1030, 7, 64, 999]):
        p = torch.tensor(pos, dtype=torch.int32, device=card)
        _close(dak.decode_attention(q, k, v, p), dak.decode_attention_plain(q, k, v, p),
               dtype, str(pos))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen3-32b", "mamba2-130m", "zamba2-2.7b",
                                  "qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_model_on_the_card_matches_the_cpu(card, arch):
    cfg = get_smoke_config(arch)
    with set_backend(device="cpu"):
        params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 150)).astype(np.int32))
    toks = [torch.from_numpy(rng.integers(1, cfg.vocab, (2, 1)).astype(np.int32))
            for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        with set_backend(device=dev):
            p = params.to(dev)
            logits, cache = prefill(p, cfg, {"tokens": prompt.to(dev)}, max_len=160)
            got = [logits]
            for tok in toks:
                logits, cache = decode_step(p, cfg, tok.to(dev), cache)
                got.append(logits)
            outs[dev] = [x.cpu() for x in got] + _cache_leaves(cache)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


# ---- every group and every head width up to 256 (K5, K6), and gradients ------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,hkv,t,hd",
    [(2, 128, 4, 700, 128), (1, 64, 1, 300, 64), (2, 40, 2, 129, 128),  # groups 32, 64, 20
     (3, 8, 2, 500, 33), (2, 8, 2, 300, 96), (2, 8, 2, 300, 200), (2, 4, 1, 1000, 256),
     (1, 2, 1, 70, 1), (2, 4, 2, 65, 255)],
)
def test_decode_attention_at_every_group_and_width(card, b, h, hkv, t, hd, dtype):
    """Groups past 16 (cut into slices of 8) and head widths the one-load
    rows do not hold (odd past 32, past 128): one launch each, against
    the plain version, pos at 0, inside and past the cache."""
    rng = np.random.default_rng(h * 7 + hd)
    q = _randn(rng, (b, h, hd), dtype, card)
    k = _randn(rng, (b, hkv, t, hd), dtype, card)
    v = _randn(rng, (b, hkv, t, hd), dtype, card)
    for pos in ([0] * b, [t - 1] * b, [t + 5] * b, rng.integers(0, t, b).tolist()):
        p = torch.tensor(pos, dtype=torch.int32, device=card)
        dak.reset_counts()
        got = dak.decode_attention(q, k, v, p)
        assert dak.COUNTS == {"decode_attention": 1, "plain": 0}
        _close(got, dak.decode_attention_plain(q, k, v, p), dtype, f"pos={pos}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [1, 8, 48, 72, 96, 112, 200, 255, 256])
def test_flash_attention_at_every_width(card, hd, dtype, causal):
    """Each width on its route (bf16 multiples of 16 up to 128 on the
    tensor cores, the rest on the any-width kernel), ragged S and T."""
    rng = np.random.default_rng(hd)
    b, h, hkv, s, t = 2, 8, 2, 200, 333
    q = _randn(rng, (b, h, s, hd), dtype, card)
    k = _randn(rng, (b, hkv, t, hd), dtype, card)
    v = _randn(rng, (b, hkv, t, hd), dtype, card)
    fak.reset_counts()
    got = fak.flash_attention(q, k, v, causal=causal)
    tc = int(fak.route(dtype, hd) == "tensor_core")
    assert fak.COUNTS == {"flash_attention": 1, "tensor_core": tc, "plain": 0}
    _close(got, fak.flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.gpu
def test_the_attention_kernels_refuse_past_256(card):
    q = torch.zeros(1, 2, 257, device=card)
    kv = torch.zeros(1, 1, 8, 257, device=card)
    with pytest.raises(ValueError, match="1 to 256"):
        dak.decode_attention(q, kv, kv, torch.tensor([3], dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="1 to 256"):
        fak.flash_attention(q[:, :, None], kv, kv)


@pytest.mark.gpu
def test_autograd_functions_on_the_card_match_autograd_of_the_plain_versions(card):
    """K4, K6 and K7's Functions in float32 on the card (forward: the
    kernels; backward: the same math as on the CPU) against autograd
    through the plain versions, within 1e-4."""
    rng = np.random.default_rng(5)

    def grads(fn, inputs):
        xs = [x.clone().requires_grad_(True) for x in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        w = [_randn(np.random.default_rng(9), o.shape, torch.float32, card) for o in outs]
        return torch.autograd.grad(sum((o * wi).sum() for o, wi in zip(outs, w)), xs)

    cases = []
    x, g = _randn(rng, (4, 33, 256), torch.float32, card), _randn(rng, (256,), torch.float32,
                                                                   card)
    cases.append((lambda a, b: rnk.rmsnorm_fn(a, b, 1e-6),
                  lambda a, b: rnk.rmsnorm_plain(a, b, 1e-6), (x, g)))
    q = _randn(rng, (2, 8, 130, 64), torch.float32, card)
    k, v = _randn(rng, (2, 2, 130, 64), torch.float32, card), _randn(
        rng, (2, 2, 130, 64), torch.float32, card)
    cases.append((lambda *a: fak.flash_attention_fn(*a), lambda *a: fak.flash_attention_plain(*a),
                  (q, k, v)))
    b, s, h, p, n = 2, 200, 4, 16, 16
    ssd = (_randn(rng, (b, s, h, p), torch.float32, card),
           torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)).to(card),
           -torch.from_numpy(rng.uniform(0.5, 2.0, h).astype(np.float32)).to(card),
           _randn(rng, (b, s, n), torch.float32, card), _randn(rng, (b, s, n), torch.float32,
                                                                 card))
    cases.append((lambda *a: ssk.ssd_scan_fn(*a, chunk=64),
                  lambda *a: ssk.ssd_scan_plain(*a, 64), ssd))
    for fn, plain, inputs in cases:
        for got, want in zip(grads(fn, inputs), grads(plain, inputs)):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4,
                                       rtol=1e-4)
