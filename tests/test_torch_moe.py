"""The port's MoE family ≡ the reference's, on the CPU.

The reference's ``init_params`` / ``moe_init`` carried over by
``from_reference_params`` (or by name), numpy-made inputs, float32: the
port's ``moe_apply`` against the reference's at the smoke config's
capacity factor (4.0, nothing drops), at 0.5 (assignments drop) and with
``no_drop``; a zero router, where every probability ties and both must
pick the lowest experts; the kept set of assignments is identical and y
and aux agree within 1e-4.  Then the Qwen3-MoE smoke config through
``prefill`` / ``decode_step`` (logits and caches, also at a group of 16
query heads per KV head and under dropping), ``ServeEngine`` token for
token against the reference's engine, and the launcher.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.ffn import _positions_in_expert as ref_positions_in_expert
from repro.models.ffn import moe_apply as ref_moe_apply
from repro.models.ffn import moe_init as ref_moe_init
from repro.models.layers import dense as ref_dense
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.backend import set_backend
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_reference_params
from repro_torch.kernels import decode_attention as dak
from repro_torch.launch import serve as launch_serve
from repro_torch.models import MoEConfig, decode_step, init_params, prefill
from repro_torch.models.ffn import (
    MoE,
    _positions_in_expert,
    drop_counts,
    moe_apply,
    moe_route,
    reset_drop_counts,
)
from repro_torch.models.model import MoELM
from repro_torch.serve.engine import Request, ServeEngine

ATOL = 1e-4
ARCH = "qwen3-moe-235b-a22b"
MLA_ARCH = "deepseek-v3-671b"


def _with_capacity(cfg, factor: float):
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _moe_pair(arch: str, seed: int, factor: float | None = None):
    """The reference's MoE parameters of ``arch``'s smoke config and the
    port's MoE holding them."""
    ref_cfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    if factor is not None:
        ref_cfg, cfg = _with_capacity(ref_cfg, factor), _with_capacity(cfg, factor)
    tree = jax.tree.map(np.asarray, ref_moe_init(jax.random.PRNGKey(seed), ref_cfg))
    with set_backend(device="cpu"):
        p = MoE(cfg, device=torch.device("cpu"))
    for name, param in p.named_parameters():
        node = tree
        for key in name.split("."):
            node = node[key]
        param.copy_(torch.from_numpy(np.array(node)))
    assert {n for n, _ in p.named_parameters()} == {
        ".".join(k.key for k in path) for path, _ in jax.tree_util.tree_leaves_with_path(tree)
    }
    return (tree, ref_cfg), (p, cfg)


def _ref_kept(tree, cfg, x: np.ndarray, no_drop: bool):
    """The reference's routing, from its own pieces: the top-k experts and
    which assignments stay within capacity."""
    m = cfg.moe
    n = x.shape[0] * x.shape[1]
    cap = n if no_drop else max(1, int(n * m.top_k / m.n_experts * m.capacity_factor))
    logits = ref_dense(tree["router"], jnp.asarray(x, jnp.float32), "bsd,de->bse")
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    pos = ref_positions_in_expert(top_i.reshape(-1), m.n_experts)
    return np.asarray(top_i), np.asarray(pos) < cap


@pytest.mark.parametrize("arch", [ARCH, MLA_ARCH])  # the shared expert: MLA_ARCH
@pytest.mark.parametrize("factor,no_drop", [(4.0, False), (0.5, False), (0.5, True)])
def test_moe_apply_matches_the_reference(arch, factor, no_drop):
    (tree, ref_cfg), (p, cfg) = _moe_pair(arch, seed=1, factor=factor)
    x = np.random.default_rng(2).standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    ref_y, ref_aux = ref_moe_apply(tree, ref_cfg, jnp.asarray(x), no_drop=no_drop)
    top_i, kept = _ref_kept(tree, ref_cfg, x, no_drop)
    with set_backend(device="cpu"):
        route = moe_route(p, cfg, torch.from_numpy(x), no_drop=no_drop)
        y, aux = moe_apply(p, cfg, torch.from_numpy(x), no_drop=no_drop)
    np.testing.assert_array_equal(route["top_i"].numpy(), top_i)
    np.testing.assert_array_equal(route["keep"].numpy(), kept)
    if factor < 1 and not no_drop:
        assert not kept.all()  # the case drops assignments
    else:
        assert kept.all()
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=ATOL)


@pytest.mark.parametrize("factor", [4.0, 0.5])
def test_a_zero_router_picks_the_lowest_experts_as_the_reference(factor):
    """Every probability ties at 1/E: ``jax.lax.top_k`` takes experts 0..k-1,
    and so must the port (``torch.topk`` promises no order on ties)."""
    (tree, ref_cfg), (p, cfg) = _moe_pair(ARCH, seed=3, factor=factor)
    tree["router"]["w"] = np.zeros_like(tree["router"]["w"])
    p.router.w.zero_()
    x = np.random.default_rng(4).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    ref_y, ref_aux = ref_moe_apply(tree, ref_cfg, jnp.asarray(x))
    top_i, kept = _ref_kept(tree, ref_cfg, x, False)
    assert (top_i == np.arange(cfg.moe.top_k)).all()
    with set_backend(device="cpu"):
        route = moe_route(p, cfg, torch.from_numpy(x))
        y, aux = moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(route["top_i"].numpy(), top_i)
    np.testing.assert_array_equal(route["keep"].numpy(), kept)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=ATOL)


def test_partial_ties_keep_the_lower_expert_first():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0]])
    from repro_torch.models.ffn import _top_k

    w, i = _top_k(probs, 4)
    want_w, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("n,e", [(1, 4), (37, 8), (512, 128), (2000, 3)])
def test_positions_in_expert_match_the_reference(n, e):
    flat = np.random.default_rng(n).integers(0, e, n).astype(np.int32)
    want = np.asarray(ref_positions_in_expert(jnp.asarray(flat), e))
    got = _positions_in_expert(torch.from_numpy(flat).long(), e)
    np.testing.assert_array_equal(got.numpy(), want)


def test_drop_counts_report_the_reference_drops():
    (tree, ref_cfg), (p, cfg) = _moe_pair(ARCH, seed=5, factor=0.5)
    x = np.random.default_rng(6).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    _, kept = _ref_kept(tree, ref_cfg, x, False)
    reset_drop_counts()
    with set_backend(device="cpu"):
        moe_apply(p, cfg, torch.from_numpy(x))
        moe_apply(p, cfg, torch.from_numpy(x), no_drop=True)  # counts nothing
    assert drop_counts() == {"routed": kept.size, "dropped": int((~kept).sum())}
    reset_drop_counts()
    assert drop_counts() == {"routed": 0, "dropped": 0}


def _ref_params(arch: str, seed: int, **overrides):
    cfg = ref_smoke_config(arch).scaled(**overrides)
    return cfg, ref_init_params(jax.random.PRNGKey(seed), cfg)


def _port(arch: str, tree, **overrides):
    cfg = get_smoke_config(arch).scaled(**overrides)
    with set_backend(device="cpu"):
        return cfg, from_reference_params(jax.tree.map(np.asarray, tree), cfg)


VARIANTS = {
    "smoke": {},
    "group 16": {"n_heads": 16, "n_kv_heads": 1},  # Qwen3-MoE's 64 / 4 GQA group
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("factor", [4.0, 0.5])
def test_prefill_and_decode_match_the_reference(variant, factor):
    overrides = dict(VARIANTS[variant])
    ref_cfg, tree = _ref_params(ARCH, 1, **overrides)
    ref_cfg = _with_capacity(ref_cfg, factor)
    cfg, params = _port(ARCH, tree, **overrides)
    cfg = _with_capacity(cfg, factor)
    assert isinstance(params, MoELM)
    rng = np.random.default_rng(7)
    b, s, max_len, steps = 2, 11, 24, 4
    prompt = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    ref_logits, ref_cache = ref_prefill(tree, ref_cfg, {"tokens": jnp.asarray(prompt)},
                                        max_len=max_len)
    dak.reset_counts()
    reset_drop_counts()
    with set_backend(device="cpu"):
        logits, cache = prefill(params, cfg, {"tokens": torch.from_numpy(prompt)},
                                max_len=max_len)
        routed = drop_counts()
        assert routed["routed"] == cfg.n_layers * b * s * cfg.moe.top_k
        assert (routed["dropped"] > 0) == (factor < 1)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
        for step in range(steps + 1):
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    cache["layers"][kv].numpy(),
                    np.asarray(ref_cache["layers"][kv]).transpose(0, 1, 3, 2, 4),
                    atol=ATOL, err_msg=f"{kv} after step {step}",
                )
            np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
            if step == steps:
                break
            tok = rng.integers(1, cfg.vocab, (b, 1)).astype(np.int32)
            ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
            logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL,
                                       err_msg=f"step {step}")
    assert drop_counts() == routed  # the decode path drops nothing and counts nothing
    assert dak.COUNTS["plain"] == steps * cfg.n_layers


def _drain(engine, n, limit=500):
    done = []
    for _ in range(limit):
        done += engine.step()
        if len(done) == n:
            break
    return {r.request_id: r.generated for r in done}


@pytest.mark.parametrize("eos", [-1, 7])
def test_engine_generates_the_reference_tokens(eos):
    ref_cfg, tree = _ref_params(ARCH, 3)
    cfg, params = _port(ARCH, tree)
    rng = np.random.default_rng(11)
    reqs = [(rid, rng.integers(1, cfg.vocab, int(rng.integers(2, 10))).astype(np.int32),
             int(rng.integers(2, 7))) for rid in range(5)]
    ref = RefEngine(tree, ref_cfg, batch_slots=2, max_len=48, eos_token=eos)
    for rid, prompt, n_new in reqs:
        ref.submit(RefRequest(rid, prompt.copy(), max_new_tokens=n_new))
    want = _drain(ref, len(reqs))
    with set_backend(device="cpu"):
        eng = ServeEngine(params, cfg, batch_slots=2, max_len=48, eos_token=eos)
        for rid, prompt, n_new in reqs:
            eng.submit(Request(rid, prompt.copy(), max_new_tokens=n_new))
        got = _drain(eng, len(reqs))
    assert len(want) == len(reqs)
    assert got == want


def test_init_params_draws_the_reference_rules():
    cfg = get_smoke_config(ARCH).scaled(
        d_model=128, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256))
    with set_backend(device="cpu"):
        a = init_params(torch.Generator().manual_seed(0), cfg)
        b = init_params(torch.Generator().manual_seed(0), cfg)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    ffn = a.layers[0].ffn
    assert ffn.router.w.dtype == torch.float32  # the fp32 router
    assert ffn.experts.wi_gate.shape == (4, 128, 256)
    assert ffn.experts.wo.shape == (4, 256, 128)
    for w, fan_in in ((ffn.experts.wi_up, 128), (ffn.experts.wo, 256), (ffn.router.w, 128)):
        assert abs(w.std().item() - fan_in**-0.5) < 0.1 * fan_in**-0.5
    assert not torch.equal(ffn.experts.wi_gate[0], ffn.experts.wi_gate[1])
    assert not hasattr(ffn, "shared")


def test_full_config_counts_as_the_reference():
    """Qwen3-MoE-235B: 235 G parameters, 22 G active (the A22B)."""
    cfg = get_config(ARCH)
    assert cfg.n_heads // cfg.n_kv_heads == 16
    assert dak.group_slices(16) == (2, 8)  # K5: two slices of 8 heads
    assert 234e9 < cfg.param_count() < 236e9
    assert 21e9 < cfg.active_param_count() < 23e9


def test_launcher_serves_the_moe_smoke_config_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
                           "--max-new", "3"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("req 0:") and lines[1].startswith("req 1:")
    assert lines[-1].startswith("served 2 requests / 6 tokens")
