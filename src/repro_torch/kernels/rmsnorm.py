"""The RMSNorm kernel's wrapper, its plain PyTorch version, and counts.

Counterpart of ``repro/kernels/rmsnorm.py``.  The TPU kernel
``_rmsnorm_kernel`` (launched by ``rmsnorm_pallas`` over 128-row blocks)
is ``csrc/rmsnorm.cu`` here, built from source at first use
(:mod:`._build`), any row count, by one of two routes (:func:`route`):
``"vector"`` — one warp a row, the row in registers as 16-byte vectors
(8 bf16 or 4 fp32), one pass over device memory, g in shared memory once
a block — where x's and g's data are 16-byte aligned, ``d`` is a
multiple of the vector and a lane holds at most 20 vectors (bf16 ``d``
<= 5120, fp32 <= 2560); else ``"scalar"``: one warp a row for ``d`` <=
1024, one block a row past that.

Both functions compute ``x * rsqrt(mean(x**2, -1) + eps) * g`` with fp32
math and the result cast back to ``x``'s dtype, over the last axis of
``x`` of any shape; ``g`` has shape ``(d,)`` and ``x``'s dtype.

- :func:`rmsnorm` launches the kernel for a CUDA tensor, or raises; it
  takes the plain version only for a tensor on the CPU.
- :func:`rmsnorm_plain` is the same function in plain PyTorch (the
  port's copy of ``repro/kernels/ref.py::rmsnorm_ref``).

``COUNTS`` holds plain integers: ``rmsnorm`` counts kernel launches,
``plain`` counts calls of the plain version.  :func:`reset_counts`
zeroes them.

The dry run's rules (:mod:`._tensors`, inside its ``counting`` scope):
a ``meta`` ``x`` gets :func:`rmsnorm`'s shape rule, ``empty_like(x)``
after the launch's checks, and every call adds :func:`op_count` and
:func:`byte_count`: the kernel's one pass, as the vector route (the
model's aligned rows) runs it.

Gradients: :func:`rmsnorm_fn` is the model's entry point.  Where autograd
records (grad mode on and ``x`` or ``g`` requiring a gradient) it applies
:class:`RMSNormFunction`, whose forward is :func:`rmsnorm` (the kernel,
or the plain version on the CPU) and whose backward is the closed form
of RMSNorm's gradient in plain PyTorch (:func:`rmsnorm_backward`): the
reference differentiates its plain jnp norm and has no backward kernel.
Elsewhere it calls :func:`rmsnorm` itself, so serving launches exactly
what it did.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._tensors import H100_SMS, active, check_device, check_dtype, count, uncounted

__all__ = [
    "COUNTS",
    "RMSNormFunction",
    "byte_count",
    "op_count",
    "reset_counts",
    "rmsnorm",
    "rmsnorm_backward",
    "rmsnorm_fn",
    "rmsnorm_plain",
    "route",
]

COUNTS = {"rmsnorm": 0, "plain": 0}
VEC_BYTES = 16  # one vector access
MAX_VECTORS_PER_LANE = 20  # the largest register row the kernel compiles
ROWS_PER_BLOCK = 8  # the vector route's rows a block (csrc kRowsPerBlock)
BLOCKS_PER_SM = 8  # the vector route's grid cap, per SM
OPS_PER_ELEMENT = 4  # square, sum, scale by the row's rsqrt, gain


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    COUNTS["plain"] += 1
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"rmsnorm: x of shape {tuple(x.shape)} has no rows")
    if g.shape != x.shape[-1:]:
        raise ValueError(
            f"rmsnorm: g of shape {tuple(g.shape)} does not match x's last "
            f"axis {x.shape[-1]}"
        )


def route(x: torch.Tensor, g: torch.Tensor) -> str:
    """The kernel's route for ``x`` and ``g`` (the C launcher's own rule;
    the output, from PyTorch's allocator, is always aligned)."""
    n = VEC_BYTES // x.element_size()
    d = x.shape[-1]
    aligned = (x.data_ptr() | g.data_ptr()) % VEC_BYTES == 0
    if aligned and d % n == 0 and -(-d // n) <= 32 * MAX_VECTORS_PER_LANE:
        return "vector"
    return "scalar"


def op_count(rows: int, d: int) -> int:
    """Operations of one call over ``rows`` rows of width ``d``: four an
    element (square, sum, scale, gain); the row's rsqrt is not counted."""
    return OPS_PER_ELEMENT * rows * d


def byte_count(rows: int, d: int, itemsize: int, sms: int = H100_SMS) -> int:
    """Device-memory bytes of one call on the vector route: x read once,
    y written once, g read once a block (a block a row where fewer than
    ``sms`` blocks of 8 rows would run, else ``ceil(rows / 8)`` blocks up
    to 8 an SM).  The scalar route reads x a second time from L1 and L2,
    not counted."""
    blocks = -(-rows // ROWS_PER_BLOCK)
    blocks = rows if blocks < sms else min(blocks, BLOCKS_PER_SM * sms)
    return (2 * rows * d + blocks * d) * itemsize


@functools.cache
def _launcher():
    fn = _build.library("rmsnorm").rmsnorm_launch
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel over the rows of ``x``; CPU tensors take
    :func:`rmsnorm_plain`, ``meta`` tensors (inside the dry run's scope)
    the shape rule.  Launches on the current stream and does not
    synchronise."""
    _check(x, g)
    code = check_dtype("rmsnorm", x, g)
    dev = check_device("rmsnorm", x, g)
    d = x.shape[-1]
    rows = x.numel() // d
    if dev == "cpu":
        if not active():
            return rmsnorm_plain(x, g, eps)
        y = torch.empty_like(x)  # the launch's output, in the counters' sight
        with uncounted():
            y.copy_(rmsnorm_plain(x, g, eps))
        _count(rows, d, x.element_size())
        return y
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("rmsnorm: x and g must be contiguous")
    y = torch.empty_like(x)
    if dev == "meta":
        _count(rows, d, x.element_size())
        return y
    err = _launcher()(
        x.data_ptr(),
        g.data_ptr(),
        y.data_ptr(),
        rows,
        d,
        float(eps),
        code,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"rmsnorm kernel launch failed with CUDA error {err} "
            f"(rows={rows}, d={d}, dtype={x.dtype})"
        )
    COUNTS["rmsnorm"] += 1
    if active():
        _count(rows, d, x.element_size())
    return y


def _count(rows: int, d: int, itemsize: int) -> None:
    count("rmsnorm", op_count(rows, d), byte_count(rows, d, itemsize))


def rmsnorm_backward(
    x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dg)`` of ``y = x * r * g``, ``r = rsqrt(mean(x**2) + eps)``,
    in fp32: ``dx = r * u - x * r**3 * mean(u * x)`` with ``u = dy * g``,
    and ``dg`` the sum over rows of ``dy * x * r``; cast to ``x``'s and
    ``g``'s dtypes."""
    xf, gf, dyf = x.float(), g.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    u = dyf * gf
    dx = r * u - xf * r.pow(3) * (u * xf).mean(-1, keepdim=True)
    dg = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dg.to(g.dtype)


class RMSNormFunction(torch.autograd.Function):
    """:func:`rmsnorm` forward, :func:`rmsnorm_backward` backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return rmsnorm(x, g, eps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, g = ctx.saved_tensors
        dx, dg = rmsnorm_backward(x, g, dy, ctx.eps)
        return dx, dg, None


def rmsnorm_fn(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm through K4, differentiable: :class:`RMSNormFunction` where
    autograd records, else :func:`rmsnorm`."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad):
        return RMSNormFunction.apply(x, g, eps)
    return rmsnorm(x, g, eps)
