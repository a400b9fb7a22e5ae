"""The port's encoder-decoder family (Whisper-medium) against the
reference, as ``tests/test_archs_smoke.py`` holds the reference itself.

The smoke config's weights carried over by ``from_reference_params``
(the encoder's ``encoder/layers`` and the decoder's ``cross`` /
``norm_x`` leaves included), the same numpy-made frame embeddings and
tokens: ``forward_train``, ``prefill`` (logits, the KV cache and the
memory) and decode steps after it match the reference within 1e-4
(float32, CPU); a step from ``init_decode_cache`` too; the
cross-attention and the encoder's attention match the reference's
``gqa_attend`` at S = 1 and 5 against T = 32, 7 and 5 keys; decode from a
prefilled cache reproduces ``forward_train`` on the extended sequence;
the plain-version counts show K4, K5 and K6 on the path (on the CPU);
the full config carries the published hyperparameters and the
reference's parameter count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import decode_step as ref_decode_step
from repro.models import forward_train as ref_forward_train
from repro.models import init_decode_cache as ref_init_decode_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.attention import gqa_attend as ref_gqa_attend
from repro_torch.backend import set_backend
from repro_torch.configs import ARCHS, WAITING, get_config, get_smoke_config
from repro_torch.convert import from_reference_params, reference_leaf
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.models import (
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
)
from repro_torch.models.attention import gqa_attend, rope_for
from repro_torch.models.model import FAMILIES, EncDecLM, check_family

ARCH = "whisper-medium"
ATOL = 1e-4
B, S = 2, 10


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
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, frames


def _batch(toks, frames):
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})


def _kv(cache) -> np.ndarray:
    """The reference's (L, B, S, Hkv, hd) cache in the port's layout."""
    return np.asarray(cache).transpose(0, 1, 3, 2, 4)


def _reset():
    for mod in (rnk, dak, fak):
        mod.reset_counts()


def test_encdec_is_a_ported_family():
    assert ARCH in ARCHS and not WAITING
    assert FAMILIES["encdec"] is EncDecLM
    check_family(get_config(ARCH))
    params = init_params(torch.Generator().manual_seed(0), get_smoke_config(ARCH))
    assert isinstance(params, EncDecLM)
    assert len(params.encoder.layers) == len(params.layers) == 2
    assert not hasattr(params.encoder.layers[0], "cross")  # the encoder is dense
    names = {n for n, _ in params.named_parameters()}
    assert {"encoder.final_norm.g", "encoder.layers.1.attn.wq.w", "layers.0.cross.wo.w",
            "layers.1.norm_x.g"} <= names
    assert reference_leaf("encoder.layers.1.ffn.wi_gate.w") == (
        ("encoder", "layers", "ffn", "wi_gate", "w"), 1)
    assert reference_leaf("encoder.final_norm.g") == (("encoder", "final_norm", "g"), None)


def test_init_params_draws_every_leaf_of_the_reference():
    """As many weights, leaf for leaf, as the reference's tree holds, the
    cross-attention drawn (not left empty)."""
    cfg = get_smoke_config(ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tree = ref_init_params(jax.random.PRNGKey(0), ref_smoke_config(ARCH))
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    w = params.layers[1].cross.wq.w
    assert abs(w.std().item() - cfg.d_model**-0.5) < 0.2 * cfg.d_model**-0.5


def test_forward_train_matches_the_reference():
    ref_cfg, tree, cfg, params = _setup(seed=0)
    ref_batch, batch = _batch(*_inputs(cfg, seed=1))
    want, want_aux, want_mtp = ref_forward_train(tree, ref_cfg, ref_batch)
    _reset()
    got, aux, mtp = forward_train(params, cfg, batch)
    assert got.shape == (B, S + 1, cfg.vocab) and mtp is None and want_mtp is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    assert float(aux) == float(want_aux) == 0.0
    # the encoder's 2L + 1 norms and L attentions, the decoder's 3L + 1 and 2L
    assert rnk.COUNTS["plain"] == (2 * cfg.n_encoder_layers + 1) + (3 * cfg.n_layers + 1)
    assert fak.COUNTS["plain"] == cfg.n_encoder_layers + 2 * cfg.n_layers
    assert rnk.COUNTS["rmsnorm"] == fak.COUNTS["flash_attention"] == 0


@pytest.mark.parametrize("steps", [1, 4])
def test_prefill_and_decode_match_the_reference(steps):
    """The frames encoded and the prompt prefilled, then decode steps:
    logits, caches (the memory included) and positions equal the
    reference's; each decode step re-projects the memory in every layer
    (one K6 call a layer) beside K5's self-attention."""
    ref_cfg, tree, cfg, params = _setup(seed=0)
    toks, frames = _inputs(cfg, seed=1, s=S + steps)
    max_len = S + steps + 2
    ref_batch, batch = _batch(toks[:, :S], frames)
    ref_logits, ref_cache = ref_prefill(tree, ref_cfg, ref_batch, max_len=max_len)
    _reset()
    logits, cache = prefill(params, cfg, batch, max_len=max_len)
    assert fak.COUNTS["plain"] == cfg.n_encoder_layers + 2 * cfg.n_layers
    assert rnk.COUNTS["plain"] == (2 * cfg.n_encoder_layers + 1) + (3 * cfg.n_layers + 1)
    assert dak.COUNTS["plain"] == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    assert cache["layers"]["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, max_len,
                                          cfg.head_dim_)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][kv].numpy(),
                                   _kv(ref_cache["layers"][kv]), atol=ATOL)
    assert cache["memory"].shape == (B, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(cache["memory"].numpy(), np.asarray(ref_cache["memory"]),
                               atol=ATOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), [S] * B)
    _reset()
    for i in range(steps):
        tok = toks[:, S + i : S + i + 1]
        ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
        logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][kv].numpy(),
                                   _kv(ref_cache["layers"][kv]), atol=ATOL)
    assert dak.COUNTS["plain"] == steps * cfg.n_layers
    assert fak.COUNTS["plain"] == steps * cfg.n_layers  # cross-attention, S = 1
    assert rnk.COUNTS["plain"] == steps * (3 * cfg.n_layers + 1)


def test_decode_only_cache_matches_the_reference():
    """A step from ``init_decode_cache``: zero keys, values and memory."""
    ref_cfg, tree, cfg, params = _setup(seed=2)
    ref_cache = ref_init_decode_cache(tree, ref_cfg, B, 16)
    cache = init_decode_cache(params, cfg, B, 16)
    assert cache["layers"]["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, 16, cfg.head_dim_)
    assert cache["memory"].shape == (B, cfg.encoder_seq, cfg.d_model)
    assert not cache["memory"].any()
    np.testing.assert_array_equal(cache["memory"].numpy(), np.asarray(ref_cache["memory"]))
    tok = np.full((B, 1), 3, np.int32)
    ref_logits, ref_cache2 = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
    logits, cache2 = decode_step(params, cfg, torch.from_numpy(tok), cache)
    assert logits.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    assert int(cache2["pos"][0]) == int(ref_cache2["pos"][0]) == 16


def test_prefill_decode_consistency():
    """Decode from a prefilled cache reproduces the full forward of the
    extended sequence (the reference's test_prefill_decode_consistency)."""
    _, _, cfg, params = _setup(seed=1)
    toks, frames = _inputs(cfg, seed=2)
    full, _, _ = forward_train(params, cfg, _batch(toks, frames)[1])
    lg_pre, cache = prefill(params, cfg, _batch(toks[:, :S], frames)[1], max_len=S + 4)
    lg_dec, _ = decode_step(params, cfg, torch.from_numpy(toks[:, S:]), cache)
    scale = float(full.abs().max())
    assert float((lg_pre[:, 0] - full[:, S - 1]).abs().max()) / scale < 2e-3
    assert float((lg_dec[:, 0] - full[:, S]).abs().max()) / scale < 2e-3


@pytest.mark.parametrize("s,t,causal", [
    (1, 32, False),  # cross-attention at decode: one query against the memory
    (5, 32, False),
    (5, 7, False),  # T != S, neither the memory's nor the prompt's length
    (1, 5, True),  # ``causal`` is forced off with a memory
    (5, None, False),  # the encoder's self-attention (no memory)
    (5, None, True),  # the decoder's self-attention
])
def test_gqa_attend_matches_the_reference(s, t, causal):
    """The port's ``gqa_attend`` (K6's plain version on the CPU) against
    the reference's: queries roped at their positions, the memory's keys
    at ``arange(T)``."""
    ref_cfg, tree, cfg, params = _setup(seed=3)
    rng = np.random.default_rng(s * 100 + (t or 0))
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    positions = np.stack([np.arange(s) + 3 * i for i in range(B)]).astype(np.int32)
    p_ref = jax.tree.map(lambda a: a[1], tree["layers"]["cross"])
    kw_ref, kw = {"causal": causal}, {"causal": causal}
    if t is not None:
        memory = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
        kw_ref["memory"] = jnp.asarray(memory)
        kw["memory"] = torch.from_numpy(memory)
        kw["memory_rope"] = rope_for(cfg, torch.arange(t)[None, :])
    want = ref_gqa_attend(p_ref, ref_cfg, jnp.asarray(x), jnp.asarray(positions), **kw_ref)
    fak.reset_counts()
    got = gqa_attend(params.layers[1].cross, cfg, torch.from_numpy(x),
                     rope_for(cfg, torch.from_numpy(positions)), **kw)
    assert fak.COUNTS["plain"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_forward_train_needs_frames():
    """Without frames the entry points raise ``KeyError``, as the
    reference's (its serve and train launchers feed tokens only)."""
    _, _, cfg, params = _setup(seed=0)
    toks = torch.zeros((B, S), dtype=torch.int32)
    with pytest.raises(KeyError, match="frames"):
        forward_train(params, cfg, {"tokens": toks})
    with pytest.raises(KeyError, match="frames"):
        prefill(params, cfg, {"tokens": toks})


def test_full_config_matches_spec():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    spec = dict(n_layers=24, n_encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
                head_dim_=64, d_ff=4096, vocab=51865, encoder_seq=1500,
                block_pattern="encdec", rope_theta=ref.rope_theta, norm_eps=ref.norm_eps,
                qkv_bias=ref.qkv_bias, qk_norm=ref.qk_norm)
    for field, value in spec.items():
        assert getattr(cfg, field) == value == getattr(ref, field), field
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    # the weights themselves: as many as the reference's full tree holds
    # (0.96 G, 1.9 GB in bf16; both packages' param_count() formula says
    # 0.91 G)
    shapes = jax.eval_shape(lambda key: ref_init_params(key, ref), jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in FAMILIES["encdec"](cfg, device="meta").parameters())
    assert n_port == n_ref and 0.95e9 < n_port < 0.97e9
    assert cfg.torch_dtype == torch.bfloat16
    smoke, ref_smoke = get_smoke_config(ARCH), ref_smoke_config(ARCH)
    assert smoke.__dict__.keys() == ref_smoke.__dict__.keys()
    assert smoke.param_count() == ref_smoke.param_count()
    # K5 and K6 at its widths: hd 64, a group of 1 (one slice)
    assert dak.lane_plan(64, 2) is not None and dak.group_slices(1) == (1, 1)
    assert fak.route(torch.bfloat16, 64) == "tensor_core"
    assert fak.route(torch.float32, 64) == "cuda_core"
