"""The port's VLM family (LLaVA-NeXT-Mistral-7B) against the reference,
as ``tests/test_archs_smoke.py`` holds the reference itself.

The smoke config's weights carried over by ``from_reference_params`` (the
dense decoder's), the same numpy-made tokens and patch embeddings:
prefill with the 16-patch prefix and decode steps after it match the
reference's logits and caches within 1e-4 (float32, CPU); decode from a
prefilled cache reproduces ``forward_train`` on the extended sequence;
a decode-only cache works; the full config carries the published
hyperparameters; launch counts show K4, K5 and K6 on the path (their
plain versions, on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
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
from repro_torch.models import (
    DenseLM,
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
)
from repro_torch.models.model import FAMILIES, check_family

ARCH = "llava-next-mistral-7b"
ATOL = 1e-4
B, S = 2, 12


@pytest.fixture(autouse=True)
def _cpu():
    with set_backend(device="cpu"):
        yield


def _setup(seed):
    ref_cfg = ref_smoke_config(ARCH)
    tree = ref_init_params(jax.random.PRNGKey(seed), ref_cfg)
    cfg = get_smoke_config(ARCH)
    return ref_cfg, tree, cfg, from_reference_params(jax.tree.map(np.asarray, tree), cfg)


def _inputs(cfg, seed, s=S + 1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return toks, patches


def _kv(cache) -> np.ndarray:
    """The reference's (L, B, S, Hkv, hd) cache in the port's layout."""
    return np.asarray(cache).transpose(0, 1, 3, 2, 4)


def test_vlm_is_a_ported_family_and_encdec_still_waits():
    """VLM is the dense decoder; encdec, which waited for a later slice,
    is ported now (tests/test_torch_encdec.py), so nothing waits."""
    assert ARCH in ARCHS and ARCH not in WAITING and "whisper-medium" in ARCHS
    assert not WAITING
    assert FAMILIES["vlm"] is DenseLM
    check_family(get_config(ARCH))
    check_family(get_config("whisper-medium"))


@pytest.mark.parametrize("steps", [1, 4])
def test_prefill_and_decode_match_the_reference(steps):
    """The patch prefix + prompt prefilled, then decode steps: logits,
    caches and positions equal the reference's."""
    ref_cfg, tree, cfg, params = _setup(seed=0)
    toks, patches = _inputs(cfg, seed=1, s=S + steps)
    max_len = cfg.n_patches + S + steps + 2
    ref_logits, ref_cache = ref_prefill(
        tree, ref_cfg, {"tokens": jnp.asarray(toks[:, :S]), "patches": jnp.asarray(patches)},
        max_len=max_len)
    for mod in (rnk, dak, fak):
        mod.reset_counts()
    logits, cache = prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :S]),
                                          "patches": torch.from_numpy(patches)},
                            max_len=max_len)
    assert fak.COUNTS["plain"] == cfg.n_layers  # K6's entry: one call a layer
    assert rnk.COUNTS["plain"] == 2 * cfg.n_layers + 1
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    assert cache["layers"]["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, max_len,
                                          cfg.head_dim_)
    np.testing.assert_array_equal(cache["pos"].numpy(), [cfg.n_patches + S] * B)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][kv].numpy(),
                                   _kv(ref_cache["layers"][kv]), atol=ATOL)
    for i in range(steps):
        tok = toks[:, S + i : S + i + 1]
        ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
        logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    assert dak.COUNTS["plain"] == steps * cfg.n_layers


def test_prefill_decode_consistency():
    """Decode from a prefilled cache reproduces the full forward of the
    extended sequence (the reference's test_prefill_decode_consistency)."""
    _, _, cfg, params = _setup(seed=1)
    toks, patches = _inputs(cfg, seed=2)
    full, _, _ = forward_train(params, cfg, {"tokens": torch.from_numpy(toks),
                                             "patches": torch.from_numpy(patches)})
    lg_pre, cache = prefill(params, cfg, {"tokens": torch.from_numpy(toks[:, :S]),
                                          "patches": torch.from_numpy(patches)},
                            max_len=cfg.n_patches + S + 4)
    lg_dec, _ = decode_step(params, cfg, torch.from_numpy(toks[:, S:]), cache)
    scale = float(full.abs().max())
    assert float((lg_pre[:, 0] - full[:, S - 1]).abs().max()) / scale < 2e-3
    assert float((lg_dec[:, 0] - full[:, S]).abs().max()) / scale < 2e-3


def test_decode_only_cache_matches_the_reference():
    ref_cfg, tree, cfg, params = _setup(seed=2)
    ref_cache = ref_init_decode_cache(tree, ref_cfg, B, 32)
    cache = init_decode_cache(params, cfg, B, 32)
    assert cache["layers"]["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, 32, cfg.head_dim_)
    tok = np.zeros((B, 1), np.int32)
    ref_logits, ref_cache2 = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
    logits, cache2 = decode_step(params, cfg, torch.from_numpy(tok), cache)
    assert logits.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    assert int(cache2["pos"][0]) == int(cache["pos"][0]) + 1 == 32


def test_text_only_batches_take_no_prefix():
    """Without ``patches`` the family is the dense decoder (the serve
    engine's path): the same logits as the reference's text-only
    prefill."""
    ref_cfg, tree, cfg, params = _setup(seed=3)
    toks, _ = _inputs(cfg, seed=4)
    want, _ = ref_prefill(tree, ref_cfg, {"tokens": jnp.asarray(toks)})
    got, cache = prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert int(cache["pos"][0]) == toks.shape[1]


def test_full_config_matches_spec():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    spec = dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
                head_dim_=128, n_patches=576, block_pattern="vlm", rope_theta=1_000_000.0)
    for field, value in spec.items():
        assert getattr(cfg, field) == value == getattr(ref, field), field
    assert cfg.param_count() == ref.param_count()
    assert 7.0e9 < cfg.param_count() < 7.4e9  # ~7.2 B: 14.5 GB in bf16
    assert cfg.torch_dtype == torch.bfloat16
    # K5 and K6 at its widths: hd 128, a group of 4
    assert dak.lane_plan(128, 2) == (8, 1) and dak.group_slices(4) == (1, 4)
    assert fak.route(torch.bfloat16, 128) == "tensor_core"


def test_init_params_builds_the_dense_decoder():
    """As many weights, leaf for leaf, as the reference's tree holds."""
    cfg = get_smoke_config(ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    assert isinstance(params, DenseLM) and len(params.layers) == cfg.n_layers
    tree = ref_init_params(jax.random.PRNGKey(0), ref_smoke_config(ARCH))
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
