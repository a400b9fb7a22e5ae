"""The port's dense model ≡ the reference model on the smoke configs.

The same parameters (the reference's ``init_params``, carried over by
``from_reference_params``) and the same numpy-made tokens go through
the reference's ``prefill`` / ``decode_step`` and the port's, in
float32 on the CPU, where the port's kernels take their plain
versions.  Logits and caches agree within 1e-4; the port keeps its
cache as (L, B, Hkv, S, hd), so the reference's (L, B, S, Hkv, hd) cache
is transposed to compare.
"""

import dataclasses

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
from repro_torch.backend import set_backend
from repro_torch.configs import ARCHS, WAITING, get_config, get_smoke_config
from repro_torch.convert import from_reference_params
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.models import decode_step, init_decode_cache, init_params, prefill

ATOL = 1e-4
SMOKE_ARCHS = ("qwen1.5-4b", "qwen3-32b")  # MHA + QKV bias; GQA kv=2 + qk-norm


def _ref_params(arch: str, seed: int, **overrides):
    cfg = ref_smoke_config(arch).scaled(**overrides)
    return cfg, ref_init_params(jax.random.PRNGKey(seed), cfg)


def _port(arch: str, tree, **overrides):
    cfg = get_smoke_config(arch).scaled(**overrides)
    with set_backend(device="cpu"):
        return cfg, from_reference_params(jax.tree.map(np.asarray, tree), cfg)


def _ref_cache_as_port(kv) -> np.ndarray:
    return np.asarray(kv).transpose(0, 1, 3, 2, 4)


def test_port_configs_equal_the_reference_configs():
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import get_config as ref_get_config

    fields = ("name", "block_pattern", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim_", "d_ff", "vocab", "qkv_bias", "qk_norm", "rope_theta",
              "norm_eps", "tie_embeddings", "dtype", "n_encoder_layers", "encoder_seq",
              "n_patches")
    for arch in ARCHS:
        for port, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_smoke_config(arch), ref_smoke_config(arch))):
            assert port.__dict__.keys() == ref.__dict__.keys()
            for field in fields:
                assert getattr(port, field) == getattr(ref, field), (arch, field)
            for field in ("moe", "mla", "mtp_depth"):  # dataclasses of each package
                got, want = getattr(port, field), getattr(ref, field)
                if dataclasses.is_dataclass(want):
                    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
                assert got == want, (arch, field)
            assert port.param_count() == ref.param_count()
            assert port.active_param_count() == ref.active_param_count()
    assert get_config("qwen1.5-4b").torch_dtype == torch.bfloat16
    # every architecture of the reference is ported: none waits for a slice
    assert sorted(ARCHS) == sorted(REF_ARCHS) and not WAITING
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    ref_cfg, tree = _ref_params(arch, seed=1)
    cfg, params = _port(arch, tree)
    rng = np.random.default_rng(7)
    b, s, max_len, steps = 2, 11, 24, 4
    prompt = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    ref_logits, ref_cache = ref_prefill(
        tree, ref_cfg, {"tokens": jnp.asarray(prompt)}, max_len=max_len
    )
    for key in rnk.COUNTS, fak.COUNTS, dak.COUNTS:
        key["plain"] = 0
    with set_backend(device="cpu"):
        logits, cache = prefill(
            params, cfg, {"tokens": torch.from_numpy(prompt)}, max_len=max_len
        )
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
        assert cache["layers"]["k"].shape == (cfg.n_layers, b, cfg.n_kv_heads, max_len,
                                              cfg.head_dim_)
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                cache["layers"][kv].numpy(),
                _ref_cache_as_port(ref_cache["layers"][kv]),
                atol=ATOL,
            )
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
        assert fak.COUNTS["plain"] == cfg.n_layers  # one K6 call per layer
        for step in range(steps):
            tok = rng.integers(1, cfg.vocab, (b, 1)).astype(np.int32)
            ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok),
                                                    ref_cache)
            logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
            np.testing.assert_allclose(
                logits.numpy(), np.asarray(ref_logits), atol=ATOL, err_msg=f"step {step}"
            )
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    cache["layers"][kv].numpy(),
                    _ref_cache_as_port(ref_cache["layers"][kv]),
                    atol=ATOL,
                )
            np.testing.assert_array_equal(cache["pos"].numpy(),
                                          np.asarray(ref_cache["pos"]))
    assert dak.COUNTS["plain"] == steps * cfg.n_layers
    norms_per_layer = 4 if cfg.qk_norm else 2
    assert rnk.COUNTS["plain"] == (steps + 1) * (norms_per_layer * cfg.n_layers + 1)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_decode_from_a_fresh_cache_matches_the_reference(arch):
    """From ``init_decode_cache``: positions overridden per slot, slots
    at different positions, one slot past the cache (the reference's
    masked write writes nothing there)."""
    ref_cfg, tree = _ref_params(arch, seed=2)
    cfg, params = _port(arch, tree)
    b, max_seq = 3, 16
    ref_cache = ref_init_decode_cache(tree, ref_cfg, b, max_seq)
    with set_backend(device="cpu"):
        cache = init_decode_cache(params, cfg, b, max_seq)
        assert cache["layers"]["k"].shape == (cfg.n_layers, b, cfg.n_kv_heads, max_seq,
                                              cfg.head_dim_)
        assert cache["layers"]["v"].dtype == cfg.torch_dtype
        np.testing.assert_array_equal(cache["pos"].numpy(), [max_seq - 1] * b)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
        rng = np.random.default_rng(3)
        pos = np.array([0, 5, max_seq + 2], np.int32)
        for _ in range(3):
            tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
            ref_cache = dict(ref_cache, pos=jnp.asarray(pos))
            cache = dict(cache, pos=torch.tensor(pos))
            ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok),
                                                    ref_cache)
            logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    cache["layers"][kv].numpy(),
                    _ref_cache_as_port(ref_cache["layers"][kv]),
                    atol=ATOL,
                )
            pos = pos + 1


def test_rope_matches_the_reference():
    from repro.models.rope import apply_rope as ref_apply_rope
    from repro_torch.models.rope import apply_rope

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = ref_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_params_carry_over_bit_for_bit():
    arch = "qwen3-32b"
    _, tree = _ref_params(arch, seed=4, dtype="bfloat16")
    cfg, params = _port(arch, tree, dtype="bfloat16")
    leaf = np.asarray(tree["layers"]["attn"]["wq"]["w"])
    assert leaf.dtype.name == "bfloat16"
    for i, layer in enumerate(params.layers):
        assert layer.attn.wq.w.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            layer.attn.wq.w.view(torch.int16).numpy(), leaf[i].view(np.int16)
        )
    got = params.embed.table.view(torch.int16).numpy()
    want = np.asarray(tree["embed"]["table"]).view(np.int16)
    np.testing.assert_array_equal(got, want)
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())


def test_converter_refuses_a_mismatched_tree():
    arch = "qwen1.5-4b"
    _, tree = _ref_params(arch, seed=5)
    tree = jax.tree.map(np.asarray, tree)
    cfg = get_smoke_config(arch)
    with set_backend(device="cpu"):
        with pytest.raises(ValueError, match="reference leaf"):
            from_reference_params(tree, cfg.scaled(d_model=32))
        extra = dict(tree, stray={"w": np.zeros(3, np.float32)})
        with pytest.raises(KeyError, match="stray"):
            from_reference_params(extra, cfg)


def test_init_params_draws_the_reference_rules():
    cfg = get_smoke_config("qwen1.5-4b").scaled(d_model=128, d_ff=512, vocab=4096)
    with set_backend(device="cpu"):
        a = init_params(torch.Generator().manual_seed(0), cfg)
        b = init_params(torch.Generator().manual_seed(0), cfg)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)  # seeded: the same draw twice
    layer = a.layers[0]
    assert torch.equal(layer.norm1.g, torch.ones(cfg.d_model))
    assert torch.equal(layer.attn.wq.b, torch.zeros(cfg.n_heads * cfg.head_dim_))
    assert abs(layer.ffn.wo.w.std().item() - cfg.d_ff**-0.5) < 0.1 * cfg.d_ff**-0.5
    assert abs(a.embed.table.std().item() - 0.02) < 0.002
    assert not any(p.requires_grad for p in a.parameters())


def test_other_families_wait_for_their_slice():
    """No family waits any more: encdec, the last, builds its encoder and
    cross-attention; a block pattern the reference lacks is still
    refused, naming the families the port runs."""
    cfg = get_smoke_config("whisper-medium")
    with set_backend(device="cpu"):
        params = init_params(torch.Generator().manual_seed(0), cfg)
        assert len(params.encoder.layers) == cfg.n_encoder_layers
        assert hasattr(params.layers[0], "cross")
        with pytest.raises(NotImplementedError, match="encdec"):
            init_params(torch.Generator().manual_seed(0),
                        cfg.scaled(block_pattern="retnet"))
