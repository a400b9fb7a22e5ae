"""The port's Mamba2 and Zamba2 models and their serving ≡ the reference's.

The same parameters (the reference's ``init_params``, carried over by
``from_reference_params``) and the same numpy-made tokens go through the
reference's Mamba2 block, ``prefill`` / ``decode_step`` and
``ServeEngine`` and the port's, in float32 on the CPU, where the port's
kernels (K7 the SSD scan, K4, K5, K6) take their plain versions.
Outputs and states agree within 1e-4; served tokens are identical.  The
port keeps zamba2's Mamba2 state flat over its layers, ``(L, ...)``,
and its attention cache as ``(n_super, B, Hkv, S, hd)``; the
reference's ``(n_super, period, ...)`` and ``(n_super, B, S, Hkv, hd)``
are reshaped to compare.
"""

import contextlib
import io

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
from repro.models import ssm as ref_ssm
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.backend import set_backend
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_reference_params
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Mamba2LM, Zamba2LM, decode_step, init_decode_cache
from repro_torch.models import init_params, prefill
from repro_torch.models import ssm
from repro_torch.serve.engine import Request, ServeEngine

ATOL = 1e-4
SSM_ARCHS = ("mamba2-130m", "zamba2-2.7b")


def _models(arch: str, seed: int):
    ref_cfg = ref_smoke_config(arch)
    tree = ref_init_params(jax.random.PRNGKey(seed), ref_cfg)
    cfg = get_smoke_config(arch)
    with set_backend(device="cpu"):
        params = from_reference_params(jax.tree.map(np.asarray, tree), cfg)
    return (tree, ref_cfg), (params, cfg)


def _close(got: torch.Tensor, want, msg: str = "") -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=msg)


def _ref_cache_as_port(cfg, cache: dict) -> dict:
    """The reference's cache leaves in the port's layouts."""
    layers = cache["layers"]
    if cfg.block_pattern == "mamba2":
        return {"conv": np.asarray(layers["conv"]), "ssm": np.asarray(layers["ssm"])}
    flat = {k: np.asarray(v).reshape((cfg.n_layers,) + v.shape[2:])
            for k, v in layers["mamba"].items()}
    kv = {f"attn.{k}": np.asarray(v).transpose(0, 1, 3, 2, 4)
          for k, v in layers["attn"].items()}
    return {**flat, **kv}


def _port_cache(cfg, cache: dict) -> dict:
    layers = cache["layers"]
    if cfg.block_pattern == "mamba2":
        return dict(layers)
    return {**layers["mamba"], **{f"attn.{k}": v for k, v in layers["attn"].items()}}


def _check_cache(cfg, cache, ref_cache, msg=""):
    want = _ref_cache_as_port(cfg, ref_cache)
    got = _port_cache(cfg, cache)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, (key, msg)
        _close(got[key], want[key], f"{key} {msg}")
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))


def test_port_ssm_configs_equal_the_reference_configs():
    """The SSM fields (the other fields and the parameter count are held
    for every arch by ``tests/test_torch_models.py``)."""
    for arch in SSM_ARCHS:
        for port, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_smoke_config(arch), ref_smoke_config(arch))):
            assert port.ssm.__dict__ == ref.ssm.__dict__
            assert port.hybrid_period == ref.hybrid_period
    assert get_config("zamba2-2.7b").head_dim_ == 80


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba2_block_matches_the_reference(arch):
    """``mamba2_apply`` from zero and from a given state, and
    ``mamba2_decode``, on one converted block."""
    (tree, ref_cfg), (params, cfg) = _models(arch, seed=1)
    ref_p = jax.tree.map(lambda a: a[0], tree["layers"]["mamba"])
    port_p = params.layers[0].mamba
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want, (ref_conv, ref_h) = ref_ssm.mamba2_apply(ref_p, ref_cfg, jnp.asarray(u))
    with set_backend(device="cpu"):
        ssk.reset_counts()
        got, (conv, h) = ssm.mamba2_apply(port_p, cfg, torch.from_numpy(u))
        assert ssk.COUNTS == {"ssd_scan": 0, "tensor_core": 0, "plain": 1}
        _close(got, want, "apply")
        _close(conv, ref_conv, "conv state")
        _close(h, ref_h, "ssm state")
        # from the state the first 64 positions left, over 32 more
        u2 = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
        want, (ref_conv2, ref_h2) = ref_ssm.mamba2_apply(
            ref_p, ref_cfg, jnp.asarray(u2), (ref_conv, ref_h))
        got, (conv2, h2) = ssm.mamba2_apply(port_p, cfg, torch.from_numpy(u2), (conv, h))
        _close(got, want, "apply from a state")
        _close(conv2, ref_conv2)
        _close(h2, ref_h2)
        for step in range(3):
            ut = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            want, (ref_conv, ref_h) = ref_ssm.mamba2_decode(
                ref_p, ref_cfg, jnp.asarray(ut), (ref_conv, ref_h))
            got, (conv, h) = ssm.mamba2_decode(port_p, cfg, torch.from_numpy(ut), (conv, h))
            _close(got, want, f"decode {step}")
            _close(conv, ref_conv)
            _close(h, ref_h)


@pytest.mark.parametrize("s", [11, 64])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_and_decode_match_the_reference(arch, s):
    (tree, ref_cfg), (params, cfg) = _models(arch, seed=3)
    rng = np.random.default_rng(7)
    b, max_len, steps = 2, s + 8, 4
    prompt = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    ref_logits, ref_cache = ref_prefill(tree, ref_cfg, {"tokens": jnp.asarray(prompt)},
                                        max_len=max_len)
    for mod in (rnk, fak, dak, ssk):
        mod.reset_counts()
    with set_backend(device="cpu"):
        logits, cache = prefill(params, cfg, {"tokens": torch.from_numpy(prompt)},
                                max_len=max_len)
        _close(logits, ref_logits, "prefill logits")
        _check_cache(cfg, cache, ref_cache, "prefill")
        assert ssk.COUNTS["plain"] == cfg.n_layers  # one K7 call per Mamba2 layer
        uses = cfg.n_layers // cfg.hybrid_period if arch == "zamba2-2.7b" else 0
        assert fak.COUNTS["plain"] == uses
        for step in range(steps):
            tok = rng.integers(1, cfg.vocab, (b, 1)).astype(np.int32)
            ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
            logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
            _close(logits, ref_logits, f"step {step}")
            _check_cache(cfg, cache, ref_cache, f"step {step}")
    assert dak.COUNTS["plain"] == steps * uses
    norms = 2 * cfg.n_layers + 2 * uses + 1  # norm1 + gated norm; shared block; final
    assert rnk.COUNTS["plain"] == (steps + 1) * norms


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_from_a_fresh_cache_matches_the_reference(arch):
    """From ``init_decode_cache``, slots at different positions (zamba2's
    attention reads up to each)."""
    (tree, ref_cfg), (params, cfg) = _models(arch, seed=4)
    b, max_seq = 3, 16
    ref_cache = ref_init_decode_cache(tree, ref_cfg, b, max_seq)
    rng = np.random.default_rng(5)
    pos = np.array([0, 5, 9], np.int32)
    with set_backend(device="cpu"):
        cache = init_decode_cache(params, cfg, b, max_seq)
        _check_cache(cfg, cache, ref_cache, "fresh")
        assert cache["layers"]["ssm" if arch == "mamba2-130m" else "mamba"] is not None
        for _ in range(3):
            tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
            ref_cache = dict(ref_cache, pos=jnp.asarray(pos))
            cache = dict(cache, pos=torch.tensor(pos))
            ref_logits, ref_cache = ref_decode_step(tree, ref_cfg, jnp.asarray(tok), ref_cache)
            logits, cache = decode_step(params, cfg, torch.from_numpy(tok), cache)
            _close(logits, ref_logits)
            _check_cache(cfg, cache, ref_cache)
            pos = pos + 1


def test_converter_builds_each_family_and_refuses_a_mismatched_tree():
    for arch, family in (("mamba2-130m", Mamba2LM), ("zamba2-2.7b", Zamba2LM)):
        (tree, _), (params, cfg) = _models(arch, seed=5)
        assert type(params) is family
        tree = jax.tree.map(np.asarray, tree)
        leaf = tree["layers"]["mamba"]["A_log"]
        assert leaf.shape[0] == cfg.n_layers  # zamba2's layers stacked flat
        for i, layer in enumerate(params.layers):
            assert layer.mamba.A_log.dtype == torch.float32
            np.testing.assert_array_equal(layer.mamba.A_log.numpy(), leaf[i])
        with set_backend(device="cpu"):
            extra = dict(tree, stray={"w": np.zeros(3, np.float32)})
            with pytest.raises(KeyError, match="stray"):
                from_reference_params(extra, cfg)
            layers = dict(tree["layers"], mamba={
                k: v for k, v in tree["layers"]["mamba"].items() if k != "dt_bias"})
            with pytest.raises(KeyError, match="dt_bias"):
                from_reference_params(dict(tree, layers=layers), cfg)
    with set_backend(device="cpu"):
        no_shared = {k: v for k, v in tree.items() if k != "shared_attn"}
        with pytest.raises(KeyError, match="shared_attn"):
            from_reference_params(no_shared, cfg)


def test_init_params_draws_the_reference_rules():
    cfg = get_smoke_config("mamba2-130m").scaled(d_model=128)
    with set_backend(device="cpu"):
        a = init_params(torch.Generator().manual_seed(0), cfg)
        b = init_params(torch.Generator().manual_seed(0), cfg)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    m = a.layers[0].mamba
    assert abs(m.conv_w.std().item() - 0.1) < 0.01
    assert abs(m.out_proj.std().item() - m.out_proj.shape[0] ** -0.5) < 0.1 * m.out_proj.shape[0] ** -0.5
    assert torch.equal(m.A_log, torch.zeros_like(m.A_log))
    assert torch.equal(m.D, torch.ones_like(m.D)) and m.D.dtype == torch.float32
    assert torch.equal(m.conv_b, torch.zeros_like(m.conv_b))
    cfg = get_smoke_config("zamba2-2.7b")
    with set_backend(device="cpu"):
        z = init_params(torch.Generator().manual_seed(0), cfg)
    assert z.shared_attn.attn.wq.w.std().item() > 0
    assert not any(p.requires_grad for p in z.parameters())


def _drain(engine, n, limit=500):
    done = []
    for _ in range(limit):
        done += engine.step()
        if len(done) == n:
            break
    return {r.request_id: r.generated for r in done}


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("eos", [-1, 7])
def test_engine_generates_the_reference_tokens(arch, eos):
    """Continuous batching over more requests than slots: requests are
    admitted while others run, and slots are reused."""
    (tree, ref_cfg), (params, cfg) = _models(arch, seed=6)
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


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_pad_tokens_advance_the_other_slots_state_as_in_the_reference(arch):
    """The reference's engine feeds pad token 0 to every other slot while
    it feeds a prompt, and resets nothing when a slot is reused: a KV
    cache masks those steps out, a Mamba2 state does not.  Both packages
    do this alike (a fault of both, kept so the tokens agree): admitting
    a request changes the state of the one already running, and a reused
    slot starts from the state its last request left."""
    (tree, ref_cfg), (params, cfg) = _models(arch, seed=8)
    first = np.array([5, 9, 3, 4], np.int32)
    second = np.array([8, 2, 6, 1, 7], np.int32)

    def run(engines, with_second: bool):
        ref, port = engines
        for eng, req in ((ref, RefRequest), (port, Request)):
            eng.submit(req(0, first.copy(), max_new_tokens=6))
            eng.step()
            eng.step()
            if with_second:
                eng.submit(req(1, second.copy(), max_new_tokens=2))
            eng.step()  # admits the second request: 4 pad steps for slot 0

    def engines():
        with set_backend(device="cpu"):
            return (RefEngine(tree, ref_cfg, batch_slots=2, max_len=48, eos_token=-1),
                    ServeEngine(params, cfg, batch_slots=2, max_len=48, eos_token=-1))

    def slot_state(engines, slot):
        ref, port = engines
        key = "ssm" if cfg.block_pattern == "mamba2" else "mamba"
        ref_layers = ref.cache["layers"] if key == "ssm" else ref.cache["layers"]["mamba"]
        port_layers = port.cache["layers"] if key == "ssm" else port.cache["layers"]["mamba"]
        want = np.asarray(ref_layers["ssm"]).reshape((cfg.n_layers,) + port_layers["ssm"].shape[1:])
        return port_layers["ssm"][:, slot], want[:, slot]

    with set_backend(device="cpu"):
        alone, shared = engines(), engines()
        run(alone, with_second=False)
        run(shared, with_second=True)
        got_alone, want_alone = slot_state(alone, 0)
        got_shared, want_shared = slot_state(shared, 0)
        _close(got_alone, want_alone)
        _close(got_shared, want_shared)
        # the admission moved slot 0's state: the pad tokens went through it
        assert (got_alone - got_shared).abs().max() > 1e-3
        assert np.abs(want_alone - want_shared).max() > 1e-3
        # drain both; slot 1 is then free but keeps the state it had
        for eng in shared:
            for _ in range(12):
                eng.step()
        assert shared[1].slots == [None, None]
        got, want = slot_state(shared, 1)
        _close(got, want)
        assert got.abs().max() > 1e-3


def test_launcher_serves_the_mamba2_smoke_config_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                           "--requests", "2", "--max-new", "3"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("req 0:") and lines[1].startswith("req 1:")
    assert lines[-1].startswith("served 2 requests / 6 tokens")
    assert lines[-1].endswith("cpu)")
