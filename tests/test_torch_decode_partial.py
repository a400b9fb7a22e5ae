"""K5's partial mode (``kernels/decode_attention.py``) and the shard-local
cache write, on the CPU.

- ``decode_attention_partial_plain`` over a cache cut by the sequence into
  m in {2, 4, 16} shards, each shard given its local positions
  (``pos - offset``, negative where the shard lies wholly past ``pos``),
  the shards' ``(out, lse)`` combined by ``combine_partials``: equal to
  ``decode_attention_plain`` over the whole cache and to the reference's
  ``decode_attention_ref`` and Pallas kernel (interpret mode); groups 1,
  4 and 8; rows at different positions, empty shards among them; float32
  within 1e-6, bf16 within ``tests/test_kernels.py``'s 2e-2.
- A shard with no key gives ``out = 0``, ``lse = -inf``; one shard (m = 1)
  is the whole cache, its ``lse`` the logits' log-sum-exp.
- The wrapper on the CPU takes the plain version and counts it; inside
  the dry run's counting scope a ``meta`` input gets the shape rule (fp32
  ``out`` and ``lse`` (B, H)) and the counts ``op_count`` and
  ``byte_count(..., lse=True)``, which adds the fp32 output's extra bytes
  and ``4 * B * H`` for ``lse``; a CPU input gives the plain result and
  the same counts.
- The launch's C signature takes the ``lse`` pointer the wrapper passes.
- ``cache_slots`` / ``write_rows`` at a negative (shard-local) position
  write nothing, nor past the cache; inside it, the row.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as ref_decode_attention
from repro.kernels import ref
from repro_torch.kernels import _tensors
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import ops
from repro_torch.models.attention import cache_slots, write_rows

F32_TOL, BF16_TOL = 1e-6, 2e-2  # float32; tests/test_kernels.py's bf16 tolerance
SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/decode_attention.cu"


def _inputs(b: int, h: int, hkv: int, t: int, hd: int, dtype, pos, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((b, h, hd), (b, hkv, t, hd), (b, hkv, t, hd)))
    return q, k, v, torch.tensor(pos, dtype=torch.int32)


def _sharded(q, k, v, pos, m: int):
    """Each of ``m`` sequence shards' partials at its local positions,
    stacked: (m, B, H, hd), (m, B, H)."""
    width = k.shape[2] // m
    outs, lses = zip(*(dak.decode_attention_partial_plain(
        q, k[:, :, r * width:(r + 1) * width].contiguous(),
        v[:, :, r * width:(r + 1) * width].contiguous(), pos - r * width) for r in range(m)))
    return torch.stack(outs), torch.stack(lses)


# rows at different positions: the first shard's start, inside one
# shard, at a shard's last position, the cache's end, past it
CASES = [
    (4, 4, 4, 64, 16, [0, 37, 63, 200]),  # group 1
    (3, 8, 2, 128, 32, [5, 64, 127]),  # group 4
    (2, 16, 2, 256, 64, [15, 250]),  # group 8
]


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("b,h,hkv,t,hd,pos", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shards_combined_equal_the_whole_cache(b, h, hkv, t, hd, pos, m, dtype):
    q, k, v, p = _inputs(b, h, hkv, t, hd, dtype, pos, seed=t + m)
    outs, lses = _sharded(q, k, v, p, m)
    assert outs.dtype == lses.dtype == torch.float32
    assert outs.shape == (m, b, h, hd) and lses.shape == (m, b, h)
    width = t // m
    empty = (p[None, :] - torch.arange(m)[:, None] * width) < 0  # (m, B)
    assert bool(empty.any())  # every case leaves some shard past a row's position
    assert bool((lses[empty] == float("-inf")).all()) and bool((outs[empty] == 0).all())
    assert bool(torch.isfinite(lses[~empty]).all())
    got = dak.combine_partials(outs, lses)
    whole = dak.decode_attention_plain(q, k, v, p).float()
    want = ref.decode_attention_ref(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                                    jnp.asarray(p.numpy()))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, whole, rtol=0, atol=tol)
    if dtype == torch.float32:
        assert np.abs(got.numpy() - np.asarray(want)).max() <= tol


@pytest.mark.parametrize("b,h,hkv,t,hd,pos", [
    (2, 4, 4, 512, 16, [0, 300]),  # group 1
    (3, 8, 2, 1024, 32, [5, 600, 1023]),  # group 4
    (2, 16, 2, 512, 64, [130, 511]),  # group 8
])
def test_shards_combined_equal_the_references_pallas_kernel(b, h, hkv, t, hd, pos):
    """The reference's K5 (``decode_attention_pallas``, interpret mode; its
    cache a multiple of its 512-row block, positions inside it) against
    the port's 4 shards' combined partials, float32."""
    q, k, v, p = _inputs(b, h, hkv, t, hd, torch.float32, pos, seed=t)
    got = dak.combine_partials(*_sharded(q, k, v, p, 4))
    want = ref_decode_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v, p)))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-5  # the reference's f32 tolerance


def test_one_shard_is_the_whole_cache_and_lse_the_logsumexp():
    q, k, v, p = _inputs(2, 4, 2, 32, 8, torch.float32, [3, 31], seed=1)
    out, lse = dak.decode_attention_partial_plain(q, k, v, p)
    torch.testing.assert_close(out, dak.decode_attention_plain(q, k, v, p), rtol=0, atol=F32_TOL)
    logits = torch.einsum("bngh,bnth->bngt", q.reshape(2, 2, 2, 8), k) * 8**-0.5
    logits[0, ..., 4:] = -torch.inf
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1).reshape(2, 4),
                               rtol=0, atol=F32_TOL)
    torch.testing.assert_close(dak.combine_partials(out[None], lse[None]), out, rtol=0, atol=0)


def test_no_shard_with_a_key_combines_to_zero():
    outs = torch.zeros(3, 1, 2, 4)
    lses = torch.full((3, 1, 2), float("-inf"))
    assert torch.equal(dak.combine_partials(outs, lses), torch.zeros(1, 2, 4))


def test_the_wrapper_takes_the_plain_version_on_the_cpu_and_counts_it():
    q, k, v, p = _inputs(2, 8, 2, 16, 8, torch.bfloat16, [3, -4], seed=2)
    dak.reset_counts()
    out, lse = ops.decode_attention_partial(q, k, v, p)
    assert dak.COUNTS == {"decode_attention": 0, "decode_attention_partial": 0, "plain": 1}
    want_out, want_lse = dak.decode_attention_partial_plain(q, k, v, p)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert bool((out[1] == 0).all()) and bool((lse[1] == float("-inf")).all())
    with pytest.raises(ValueError, match="pos must be int32"):
        dak.decode_attention_partial(q, k, v, p.long())
    with pytest.raises(ValueError, match="meta tensors"):
        dak.decode_attention_partial(*(x.to("meta") for x in (q, k, v, p)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_shape_rule_and_counts(dtype):
    """The dry run's rule: fp32 ``out`` (B, H, hd) and ``lse`` (B, H) on
    ``meta``, one call of ``decode_attention_partial`` with the partial
    mode's counts; a CPU input inside the scope returns the plain result
    and adds the same counts."""
    b, h, hkv, t, hd = 8, 64, 8, 2048, 128  # Qwen3-32B decode_32k's shard on a rank
    item = torch.tensor([], dtype=dtype).element_size()
    want = {"calls": 1, "ops": dak.op_count(b, h, hkv, t, hd),
            "bytes": dak.byte_count(b, h, hkv, t, hd, item, lse=True)}
    assert want["ops"] == 4 * b * h * t * hd
    assert want["bytes"] - dak.byte_count(b, h, hkv, t, hd, item) == \
        b * h * hd * (4 - item) + 4 * b * h
    meta = [torch.empty(s, dtype=dtype, device="meta")
            for s in ((b, h, hd), (b, hkv, t, hd), (b, hkv, t, hd))]
    with _tensors.counting() as counts:
        out, lse = dak.decode_attention_partial(*meta, torch.empty(b, dtype=torch.int32,
                                                                   device="meta"))
    assert (out.shape, out.dtype, out.device.type) == ((b, h, hd), torch.float32, "meta")
    assert (lse.shape, lse.dtype) == ((b, h), torch.float32)
    assert counts.by_kernel == {"decode_attention_partial": want}
    q, k, v, p = _inputs(2, 8, 2, 64, 16, dtype, [5, -1], seed=3)
    with _tensors.counting() as counts:
        out, lse = dak.decode_attention_partial(q, k, v, p)
    want_out, want_lse = dak.decode_attention_partial_plain(q, k, v, p)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert counts.by_kernel["decode_attention_partial"]["bytes"] == \
        dak.byte_count(2, 8, 2, 64, 16, q.element_size(), lse=True)


def test_the_launch_takes_the_lse_pointer_the_wrapper_passes():
    """``decode_attention_launch``'s parameters, in the source: 8 pointers
    (the 8th ``lse``), 9 ints, the scale, the dtype code and the stream,
    as the wrapper's ``argtypes`` declare them."""
    text = SOURCE.read_text()
    sig = re.search(r'extern "C" int decode_attention_launch\((.*?)\)\s*\{', text, re.S).group(1)
    params = [x.split()[-1].lstrip("*") for x in sig.split(",")]
    assert params[:8] == ["q", "k", "v", "pos", "out", "part", "tickets", "lse"]
    assert len(params) == 8 + 9 + 3
    assert "mt + logf(lt)" in text  # lse in natural-log units, from the merge's (mt, lt)


def test_a_negative_position_writes_nothing():
    """A shard-local position below the shard (``pos - offset`` < 0) is
    clamped to 0 and writes nothing; one past the cache writes nothing;
    one inside writes its row."""
    cache = torch.arange(3 * 2 * 4 * 2, dtype=torch.float32).reshape(3, 2, 4, 2)
    rows = -torch.ones(3, 2, 2)
    pos = torch.tensor([-3, 4, 1], dtype=torch.int32)
    bi, at, inside = cache_slots(pos, 4)
    assert at.tolist() == [0, 3, 1] and inside.flatten().tolist() == [False, False, True]
    want = cache.clone()
    want[2, :, 1] = -1
    write_rows(cache, rows, (bi, at, inside))
    assert torch.equal(cache, want)
