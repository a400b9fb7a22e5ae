"""The SSD scan's plain version ≡ the reference's Pallas kernel, its
sequential oracle and the model's chunked scan.

On the CPU the port's wrapper (``repro_torch.kernels.ops.ssd_scan``)
takes its kernel's plain version; the same numpy-made inputs go through
the reference's ``ssd_scan_pallas`` (interpret mode, as
``tests/test_kernels.py`` runs it), ``ref.ssd_scan_ref`` (position by
position) and ``repro.models.ssm.ssd_chunked`` (the model's path).

Tolerance 2e-4 (``tests/test_kernels.py``'s) in float32 against the
kernel and the oracle: both sum in another order, and the chunked form's
prefix sums of ``dt·a`` reach |cum| ≈ 100 within a 128-row chunk, where
an fp32 ulp is 8e-6 of every decay factor.  Against ``ssd_chunked`` at
the same chunk (the same arithmetic step for step) 1e-4.  bfloat16
inputs are read as the same fp32 values by both sides (the outputs are
fp32), so they take the float32 tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.models.ssm import ssd_chunked

KERNEL_ATOL = 2e-4
CHUNKED_ATOL = 1e-4
SHAPES = [(2, 256, 3, 64, 32), (1, 128, 2, 32, 16), (2, 384, 1, 64, 64)]


def _inputs(seed: int, b: int, s: int, h: int, p: int, n: int):
    """x, dt (post-softplus), a (< 0), bm, cm as float32 numpy arrays,
    scaled as ``tests/test_kernels.py`` scales them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.logaddexp(0.0, rng.standard_normal((b, s, h)))
    a = -np.exp(rng.standard_normal(h) * 0.3)
    bm = rng.standard_normal((b, s, n)) * 0.5
    cm = rng.standard_normal((b, s, n)) * 0.5
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


def _torch(args):
    return [torch.from_numpy(v) for v in args]


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("b,s,h,p,n", SHAPES)
def test_plain_matches_the_pallas_kernel_and_the_oracle(b, s, h, p, n):
    args = _inputs(s + p, b, s, h, p, n)
    ssk.reset_counts()
    y, h_last = ops.ssd_scan(*_torch(args), chunk=128)
    assert ssk.COUNTS == {"ssd_scan": 0, "tensor_core": 0, "plain": 1}
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert h_last.dtype == torch.float32 and h_last.shape == (b, h, p, n)
    yk, hk = ssd_scan_pallas(*map(jnp.asarray, args))
    _close(y, yk, KERNEL_ATOL, "y vs pallas")
    _close(h_last, hk, KERNEL_ATOL, "state vs pallas")
    ye, he = ref.ssd_scan_ref(*map(jnp.asarray, args))
    _close(y, ye, KERNEL_ATOL, "y vs sequential")
    _close(h_last, he, KERNEL_ATOL, "state vs sequential")


@pytest.mark.parametrize(
    "chunk,shape",
    [(32, (2, 256, 3, 16, 16)), (64, (2, 256, 2, 32, 16)), (256, (1, 512, 2, 64, 32)),
     (256, (2, 40, 3, 16, 16)), (64, (1, 7, 2, 16, 16))],
)
def test_plain_matches_the_model_chunked_scan(chunk, shape):
    """At the model's chunk, including a prompt shorter than the chunk
    (one ragged chunk of S rows)."""
    args = _inputs(chunk + shape[1], *shape)
    y, h_last = ssk.ssd_scan_plain(*_torch(args), chunk)
    ye, he = ref_ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    _close(y, ye, CHUNKED_ATOL)
    _close(h_last, he, CHUNKED_ATOL)


@pytest.mark.parametrize("s", [1, 37, 200, 333])
def test_plain_takes_any_length(s):
    """A length that is no multiple of the chunk (the reference's chunked
    scan refuses it) is padded with rows that add no input and no decay:
    the result equals the sequential oracle's."""
    args = _inputs(s, 2, s, 3, 16, 32)
    y, h_last = ssk.ssd_scan_plain(*_torch(args), 64)
    ye, he = ref.ssd_scan_ref(*map(jnp.asarray, args))
    _close(y, ye, KERNEL_ATOL)
    _close(h_last, he, KERNEL_ATOL)


def test_plain_reads_strided_slices_and_bf16():
    """The model hands over slices of one conv output; bfloat16 inputs
    give fp32 outputs equal to the float32 run on the same values."""
    b, s, h, p, n = 2, 96, 4, 16, 16
    rng = np.random.default_rng(3)
    buf = torch.from_numpy((rng.standard_normal((b, s, h * p + 2 * n)) * 0.5).astype(np.float32))
    dt, a = _torch(_inputs(4, b, s, h, p, n)[1:3])
    for dtype in (torch.float32, torch.bfloat16):
        v = buf.to(dtype)
        x = v[..., : h * p].reshape(b, s, h, p)
        bm, cm = v[..., h * p : h * p + n], v[..., h * p + n :]
        assert not x.is_contiguous() and not bm.is_contiguous()
        y, h_last = ops.ssd_scan(x, dt, a, bm, cm, chunk=32)
        assert y.dtype == torch.float32
        args = [t.float().contiguous().numpy() for t in (x, dt, a, bm, cm)]
        ye, he = ref.ssd_scan_ref(*map(jnp.asarray, args))
        _close(y, ye, KERNEL_ATOL, str(dtype))
        _close(h_last, he, KERNEL_ATOL, str(dtype))


def test_the_model_scan_carries_an_initial_state():
    """``ssd_chunked`` with ``h0`` (kernel + the state's decayed
    contribution) ≡ the reference's ``ssd_chunked`` with ``h0``."""
    b, s, h, p, n = 2, 128, 3, 16, 16
    args = _inputs(5, b, s, h, p, n)
    h0 = np.random.default_rng(6).standard_normal((b, h, p, n)).astype(np.float32)
    y, h_last = ssd_chunked(*_torch(args), 32, torch.from_numpy(h0))
    ye, he = ref_ssd_chunked(*map(jnp.asarray, args), chunk=32, h0=jnp.asarray(h0))
    _close(y, ye, CHUNKED_ATOL)
    _close(h_last, he, CHUNKED_ATOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, a, bm, cm = _torch(_inputs(7, 1, 64, 2, 16, 16))
    with pytest.raises(ValueError, match="shapes"):
        ops.ssd_scan(x[0], dt, a, bm, cm)
    with pytest.raises(ValueError, match="disagrees"):
        ops.ssd_scan(x, dt[:, :32], a, bm, cm)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x.bfloat16(), dt, a, bm, cm)
    with pytest.raises(ValueError, match="divide"):
        ssk.ssd_chunked_plain(x, dt, a, bm, cm, 48)
