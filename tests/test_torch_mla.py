"""The port's MLA + MoE family (DeepSeek-V3) ≡ the reference's, on the CPU.

The reference's ``init_params`` / ``mla_init`` carried over by
``from_reference_params`` (or by name), numpy-made tokens, float32: MLA's
prefill and decode against the reference's (outputs and the latent
``c_kv`` / ``k_rope`` cache rows, a slot past the cache included); the
DeepSeek-V3 smoke config through ``prefill`` / ``decode_step`` (logits
and caches within 1e-4, at the smoke capacity and under dropping), its
MTP head carried over and held; ``ServeEngine`` token for token against
the reference's engine; the launcher.
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
from repro.models import init_decode_cache as ref_init_decode_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.attention import mla_decode as ref_mla_decode
from repro.models.attention import mla_init as ref_mla_init
from repro.models.attention import mla_prefill as ref_mla_prefill
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.backend import set_backend
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_reference_params
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, init_decode_cache, init_params, prefill
from repro_torch.models.attention import (
    MLA,
    cache_slots,
    mla_decode,
    mla_prefill,
    rope_for,
)
from repro_torch.models.model import MLAMoELM
from repro_torch.serve.engine import Request, ServeEngine

ATOL = 1e-4
ARCH = "deepseek-v3-671b"


def _mla_pair(seed: int):
    ref_cfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, ref_mla_init(jax.random.PRNGKey(seed), ref_cfg))
    with set_backend(device="cpu"):
        p = MLA(cfg, device=torch.device("cpu"))
    for name, param in p.named_parameters():
        mod, leaf = name.split(".")
        param.copy_(torch.from_numpy(np.array(tree[mod][leaf])))
    return (tree, ref_cfg), (p, cfg)


def test_mla_prefill_and_decode_match_the_reference():
    (tree, ref_cfg), (p, cfg) = _mla_pair(seed=1)
    m = cfg.mla
    rng = np.random.default_rng(2)
    b, s, s_max = 3, 9, 14
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s), (b, s))
    ref_out, ref_cache = ref_mla_prefill(tree, ref_cfg, jnp.asarray(x), jnp.asarray(positions))
    with set_backend(device="cpu"):
        rope = rope_for(cfg, torch.from_numpy(positions.copy()))
        assert rope[0].shape[-1] == m.qk_rope_head_dim // 2  # RoPE on the rope columns only
        out, c_kv, k_rope = mla_prefill(p, cfg, torch.from_numpy(x), rope)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(c_kv.numpy(), np.asarray(ref_cache["c_kv"]), atol=ATOL)
    np.testing.assert_allclose(k_rope.numpy(), np.asarray(ref_cache["k_rope"]), atol=ATOL)

    # decode against a cache of s_max rows: slots at different positions,
    # one past the cache (the masked write writes nothing there)
    ref_c = np.zeros((b, s_max, m.kv_lora_rank), np.float32)
    ref_r = np.zeros((b, s_max, m.qk_rope_head_dim), np.float32)
    ref_c[:, :s], ref_r[:, :s] = np.asarray(ref_cache["c_kv"]), np.asarray(ref_cache["k_rope"])
    cache_c, cache_r = torch.from_numpy(ref_c.copy()), torch.from_numpy(ref_r.copy())
    ref_cache = {"c_kv": jnp.asarray(ref_c), "k_rope": jnp.asarray(ref_r)}
    pos = np.array([s, 3, s_max + 1], np.int32)
    for step in range(3):
        xt = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        ref_out, ref_cache = ref_mla_decode(tree, ref_cfg, jnp.asarray(xt), ref_cache,
                                            jnp.asarray(pos))
        with set_backend(device="cpu"):
            tp = torch.from_numpy(pos)
            out = mla_decode(p, cfg, torch.from_numpy(xt), cache_c, cache_r, tp,
                             rope_for(cfg, tp[:, None]), cache_slots(tp, s_max))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(cache_c.numpy(), np.asarray(ref_cache["c_kv"]), atol=ATOL)
        np.testing.assert_allclose(cache_r.numpy(), np.asarray(ref_cache["k_rope"]), atol=ATOL)
        pos = pos + 1
    # the slot past the cache kept its prefill rows: nothing was written
    np.testing.assert_array_equal(cache_c[2].numpy(), ref_c[2])


def _ref_params(seed: int, **overrides):
    cfg = ref_smoke_config(ARCH).scaled(**overrides)
    return cfg, ref_init_params(jax.random.PRNGKey(seed), cfg)


def _port(tree, **overrides):
    cfg = get_smoke_config(ARCH).scaled(**overrides)
    with set_backend(device="cpu"):
        return cfg, from_reference_params(jax.tree.map(np.asarray, tree), cfg)


def test_mtp_head_is_carried_over_and_held():
    _, tree = _ref_params(4)
    cfg, params = _port(tree)
    assert isinstance(params, MLAMoELM)
    np.testing.assert_array_equal(params.mtp.proj.w.numpy(), np.asarray(tree["mtp"]["proj"]["w"]))
    np.testing.assert_array_equal(params.mtp.block.attn.wkv_b.w.numpy(),
                                  np.asarray(tree["mtp"]["block"]["attn"]["wkv_b"]["w"]))
    np.testing.assert_array_equal(params.mtp.block.ffn.experts.wo.numpy(),
                                  np.asarray(tree["mtp"]["block"]["ffn"]["experts"]["wo"]))
    _, tree0 = _ref_params(4, mtp_depth=0)
    _, params0 = _port(tree0, mtp_depth=0)
    assert not hasattr(params0, "mtp")
    with set_backend(device="cpu"), pytest.raises(KeyError, match="mtp"):
        from_reference_params(jax.tree.map(np.asarray, tree), cfg.scaled(mtp_depth=0))


@pytest.mark.parametrize("factor", [4.0, 0.5])
def test_prefill_and_decode_match_the_reference(factor):
    ref_cfg, tree = _ref_params(1)
    cfg, params = _port(tree)
    ref_cfg = ref_cfg.scaled(moe=dataclasses.replace(ref_cfg.moe, capacity_factor=factor))
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    rng = np.random.default_rng(7)
    b, s, max_len, steps = 2, 11, 24, 4
    prompt = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    ref_logits, ref_cache = ref_prefill(tree, ref_cfg, {"tokens": jnp.asarray(prompt)},
                                        max_len=max_len)
    for mod in (rnk, dak, fak):
        mod.reset_counts()
    with set_backend(device="cpu"):
        logits, cache = prefill(params, cfg, {"tokens": torch.from_numpy(prompt)},
                                max_len=max_len)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
        assert cache["layers"]["c_kv"].shape == (cfg.n_layers, b, max_len, cfg.mla.kv_lora_rank)
        for step in range(steps + 1):
            for key in ("c_kv", "k_rope"):
                np.testing.assert_allclose(cache["layers"][key].numpy(),
                                           np.asarray(ref_cache["layers"][key]), atol=ATOL,
                                           err_msg=f"{key} after step {step}")
            np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
            if step == steps:
                break
            tok = rng.integers(1, cfg.vocab, (b, 1)).astype(np.int32)
            ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
            logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL,
                                       err_msg=f"step {step}")
    # MLA calls no attention kernel; its four norms a layer and the final
    # norm go through K4
    assert dak.COUNTS["plain"] == fak.COUNTS["plain"] == 0
    assert rnk.COUNTS["plain"] == (steps + 1) * (4 * cfg.n_layers + 1)


def test_decode_from_a_fresh_cache_matches_the_reference():
    ref_cfg, tree = _ref_params(2)
    cfg, params = _port(tree)
    b, max_seq = 3, 16
    ref_cache = ref_init_decode_cache(tree, ref_cfg, b, max_seq)
    with set_backend(device="cpu"):
        cache = init_decode_cache(params, cfg, b, max_seq)
        assert cache["layers"]["k_rope"].shape == (cfg.n_layers, b, max_seq,
                                                   cfg.mla.qk_rope_head_dim)
        rng = np.random.default_rng(3)
        pos = np.array([0, 5, max_seq + 2], np.int32)
        for _ in range(3):
            tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
            ref_cache = dict(ref_cache, pos=jnp.asarray(pos))
            cache = dict(cache, pos=torch.tensor(pos))
            ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
            logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
            for key in ("c_kv", "k_rope"):
                np.testing.assert_allclose(cache["layers"][key].numpy(),
                                           np.asarray(ref_cache["layers"][key]), atol=ATOL)
            pos = pos + 1


def _drain(engine, n, limit=500):
    done = []
    for _ in range(limit):
        done += engine.step()
        if len(done) == n:
            break
    return {r.request_id: r.generated for r in done}


@pytest.mark.parametrize("eos", [-1, 7])
def test_engine_generates_the_reference_tokens(eos):
    ref_cfg, tree = _ref_params(3)
    cfg, params = _port(tree)
    rng = np.random.default_rng(12)
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
    cfg = get_smoke_config(ARCH)
    with set_backend(device="cpu"):
        a = init_params(torch.Generator().manual_seed(0), cfg)
        b = init_params(torch.Generator().manual_seed(0), cfg)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    attn = a.layers[0].attn
    assert torch.equal(attn.kv_a_norm.g, torch.ones(cfg.mla.kv_lora_rank))
    assert a.layers[0].ffn.router.w.dtype == torch.float32
    assert a.layers[0].ffn.shared.wi_gate.w.shape == (cfg.d_model, cfg.moe.d_ff_expert)
    assert abs(a.mtp.proj.w.std().item() - 0.02) < 0.004  # N(0, 0.02²), not fan-in scaled
    assert a.mtp.block.ffn.experts.wi_gate.abs().sum() > 0


def test_full_config_counts_as_the_reference():
    """DeepSeek-V3 as the reference models it (every layer MoE, untied
    embeddings): 704 G parameters, 37.6 G active."""
    cfg = get_config(ARCH)
    assert cfg.block_pattern == "mla_moe" and cfg.mla.qk_rope_head_dim == 64
    assert 700e9 < cfg.param_count() < 710e9
    assert 37e9 < cfg.active_param_count() < 38e9


def test_launcher_serves_the_mla_smoke_config_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
                           "--max-new", "3"])
    lines = out.getvalue().splitlines()
    assert lines[-1].startswith("served 2 requests / 6 tokens")
