"""The model kernels' plain versions ≡ the reference's Pallas kernels and oracles.

On the CPU each wrapper of the port (``repro_torch.kernels.ops``) takes
its kernel's plain version; the same numpy-made inputs go through the
reference's Pallas kernel (``repro.kernels.ops`` with its defaults:
interpret mode on the CPU) and its pure-jnp oracle (``repro.kernels.ref``),
at the shapes of ``tests/test_kernels.py``.  Shapes the Pallas kernels
refuse (a cache length not a multiple of 512, a sequence not a multiple
of 128) are held against the oracle only.

Tolerances are ``tests/test_kernels.py``'s: 5e-5 for float32 and 2e-2
for bfloat16, the latter plus one bfloat16 rounding step (2**-7 of the
value): both sides round the same fp32 result, summed in another order,
and may land on either side of a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as ref_decode_attention
from repro.kernels import flash_attention as ref_flash_attention
from repro.kernels import ref
from repro.kernels import rmsnorm_fused as ref_rmsnorm_fused
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rnk

DTYPES = ("float32", "bfloat16")


def _tol(dtype: str) -> dict:
    return {"atol": 2e-2, "rtol": 2**-7} if dtype == "bfloat16" else {"atol": 5e-5}


def _pair(rng, shape, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _check(got: torch.Tensor, want, dtype: str, msg: str = "") -> None:
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), err_msg=msg, **_tol(dtype)
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 37, 512), (128, 256), (1, 1, 8192), (3, 5, 20, 16)])
def test_rmsnorm_plain_matches_the_reference(shape, dtype):
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    xj, xt = _pair(rng, shape, dtype)
    gj, gt = _pair(rng, shape[-1:], dtype)
    rnk.reset_counts()
    got = ops.rmsnorm_fused(xt, gt, eps=1e-6)
    assert rnk.COUNTS == {"rmsnorm": 0, "plain": 1}
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _check(got, ref_rmsnorm_fused(xj, gj).astype(jnp.float32), dtype, "pallas")
    _check(got, ref.rmsnorm_ref(xj, gj).astype(jnp.float32), dtype, "ref")


@pytest.mark.parametrize(
    "dtype,d,offset,route",
    [
        ("bfloat16", 2560, 0, "vector"),  # 320 vectors: 10 a lane
        ("bfloat16", 768, 0, "vector"),
        ("bfloat16", 128, 0, "vector"),  # qk-norm rows
        ("bfloat16", 5120, 0, "vector"),  # 20 vectors a lane, the ceiling
        ("bfloat16", 5128, 0, "scalar"),  # past 20 a lane
        ("bfloat16", 2562, 0, "scalar"),  # d off the 8-element vector
        ("bfloat16", 2560, 1, "scalar"),  # rows off a 16-byte boundary
        ("float32", 2560, 0, "vector"),  # 640 vectors: the ceiling
        ("float32", 2556, 0, "vector"),
        ("float32", 2564, 0, "scalar"),
        ("float32", 1026, 0, "scalar"),
        ("float32", 2560, 2, "scalar"),
    ],
)
def test_rmsnorm_route_rule(dtype, d, offset, route):
    """K4's vector route takes 16-byte aligned rows whose width is a
    multiple of the 16-byte vector, up to 20 vectors a lane; the rest
    take the scalar route (the C launcher's rule, mirrored)."""
    dt = getattr(torch, dtype)
    flat = torch.zeros(4 * d + 8, dtype=dt)
    x = flat[offset : offset + 4 * d].view(4, d)
    g = torch.zeros(d, dtype=dt)
    assert flat.data_ptr() % 64 == 0 == g.data_ptr() % 64  # PyTorch's CPU alignment
    assert rnk.route(x, g) == route


def _decode_inputs(b, h, hkv, t, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _pair(rng, (b, h, hd), dtype)
    k = _pair(rng, (b, hkv, t, hd), dtype)
    v = _pair(rng, (b, hkv, t, hd), dtype)
    pos = rng.integers(1, t, b).astype(np.int32)
    return q, k, v, (jnp.asarray(pos), torch.from_numpy(pos))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,hkv,t,hd", [(2, 4, 2, 1024, 64), (3, 8, 8, 512, 128), (1, 16, 4, 2048, 64)]
)
def test_decode_attention_plain_matches_the_reference(b, h, hkv, t, hd, dtype):
    (qj, qt), (kj, kt), (vj, vt), (pj, pt) = _decode_inputs(
        b, h, hkv, t, hd, dtype, seed=b * 100 + t
    )
    dak.reset_counts()
    got = ops.decode_attention(qt, kt, vt, pt)
    assert dak.COUNTS == {"decode_attention": 0, "decode_attention_partial": 0, "plain": 1}
    _check(got, ref_decode_attention(qj, kj, vj, pj).astype(jnp.float32), dtype, "pallas")
    _check(got, ref.decode_attention_ref(qj, kj, vj, pj).astype(jnp.float32), dtype, "ref")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,hkv,t,hd", [(2, 4, 2, 1000, 64), (4, 20, 20, 256, 128), (2, 4, 2, 37, 16)]
)
def test_decode_attention_plain_matches_the_oracle_at_any_length(b, h, hkv, t, hd, dtype):
    """Cache lengths the Pallas kernel refuses (T % 512 != 0)."""
    (qj, qt), (kj, kt), (vj, vt), _ = _decode_inputs(b, h, hkv, t, hd, dtype, seed=t)
    for pos in (np.zeros(b), np.full(b, t - 1), np.full(b, t + 3)):
        pos = pos.astype(np.int32)
        got = ops.decode_attention(qt, kt, vt, torch.from_numpy(pos))
        want = ref.decode_attention_ref(qj, kj, vj, jnp.asarray(pos))
        _check(got, want.astype(jnp.float32), dtype, f"pos={pos}")


def test_decode_attention_plain_respects_pos():
    """Keys beyond pos must not influence the output."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 512, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 512, 64)).astype(np.float32))
    pos = torch.tensor([100], dtype=torch.int32)
    out1 = ops.decode_attention(q, k, v, pos)
    k[:, :, 200:] = 1e4  # poison the dead region
    v[:, :, 200:] = -1e4
    np.testing.assert_allclose(ops.decode_attention(q, k, v, pos), out1, atol=1e-6)


def _flash_inputs(b, h, hkv, s, t, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return (
        _pair(rng, (b, h, s, hd), dtype),
        _pair(rng, (b, hkv, t, hd), dtype),
        _pair(rng, (b, hkv, t, hd), dtype),
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,hkv,s,hd",
    [(2, 4, 2, 256, 128), (1, 8, 8, 128, 128), (2, 2, 1, 512, 128)],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_the_reference(b, h, hkv, s, hd, dtype, causal):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(b, h, hkv, s, s, hd, dtype, seed=s + h)
    fak.reset_counts()
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert fak.COUNTS == {"flash_attention": 0, "tensor_core": 0, "plain": 1}
    want = ref_flash_attention(qj, kj, vj, causal=causal)
    _check(got, want.astype(jnp.float32), dtype, "pallas")
    want = ref.flash_attention_ref(qj, kj, vj, causal=causal)
    _check(got, want.astype(jnp.float32), dtype, "ref")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,h,hkv,s,t,hd", [(1, 4, 2, 200, 200, 64), (2, 4, 4, 129, 129, 16), (1, 4, 1, 100, 300, 32)]
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_the_oracle_at_any_length(
    b, h, hkv, s, t, hd, dtype, causal
):
    """Sequence lengths the Pallas kernel refuses (S, T % 128 != 0)."""
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(b, h, hkv, s, t, hd, dtype, seed=s)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    want = ref.flash_attention_ref(qj, kj, vj, causal=causal)
    _check(got, want.astype(jnp.float32), dtype)


def test_flash_attention_plain_matches_the_model_attention():
    """Plain version ≡ the reference model's sdpa, through the port's
    model-layout entry point (``repro_torch.models.attention.sdpa``)."""
    from repro.models.attention import sdpa as ref_sdpa
    from repro_torch.models.attention import sdpa

    rng = np.random.default_rng(1)
    b, hkv, g, s, hd = 2, 2, 2, 256, 128
    q = rng.standard_normal((b, s, hkv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    want = ref_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = sdpa(
        torch.from_numpy(q).reshape(b, s, hkv * g, hd),
        torch.from_numpy(k),
        torch.from_numpy(v),
        causal=True,
    )
    np.testing.assert_allclose(
        got.reshape(b, s, hkv, g, hd).numpy(), np.asarray(want), atol=5e-5
    )


def test_wrappers_refuse_what_no_kernel_takes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="does not match"):
        ops.rmsnorm_fused(x, torch.ones(5))
    with pytest.raises(TypeError, match="dtype"):
        ops.rmsnorm_fused(x.double(), torch.ones(8, dtype=torch.float64))
    q, kv = torch.zeros(2, 4, 16), torch.zeros(2, 3, 10, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.decode_attention(q, kv, kv, torch.zeros(2, dtype=torch.int32))
    kv = torch.zeros(2, 2, 10, 16)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q, kv, kv, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="do not form"):
        ops.flash_attention(q, kv, kv)
