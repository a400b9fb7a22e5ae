"""The port's serving stack ≡ the reference's, on the CPU.

The reference's ``ServeEngine`` and the port's run the same converted
smoke-config parameters on the same requests and must generate the same
tokens, continuous batching (more requests than slots, slots reused)
included; the routers route the same; the pool places and finishes as
``tests/test_serve.py`` asks of the reference's.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import init_params as ref_init_params
from repro.serve.engine import ReplicaRouter as RefRouter
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import RoutedServePool as RefPool
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.backend import set_backend
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference_params
from repro_torch.kernels import decode_attention as dak
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import (
    ReplicaRouter,
    Request,
    RoutedServePool,
    ServeEngine,
    make_decode_step,
    make_prefill_step,
)


def _models(arch: str, seed: int):
    ref_cfg = ref_smoke_config(arch)
    tree = ref_init_params(jax.random.PRNGKey(seed), ref_cfg)
    cfg = get_smoke_config(arch)
    with set_backend(device="cpu"):
        params = from_reference_params(jax.tree.map(np.asarray, tree), cfg)
    return (tree, ref_cfg), (params, cfg)


def _requests(rng, n, vocab):
    out = []
    for rid in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(2, 10))).astype(np.int32)
        out.append((rid, prompt, int(rng.integers(2, 7))))
    return out


def _drain(engine, n, limit=500):
    done = []
    for _ in range(limit):
        done += engine.step()
        if len(done) == n:
            break
    return {r.request_id: r.generated for r in done}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen3-32b"])
@pytest.mark.parametrize("eos", [-1, 7])
def test_engine_generates_the_reference_tokens(arch, eos):
    (tree, ref_cfg), (params, cfg) = _models(arch, seed=3)
    reqs = _requests(np.random.default_rng(11), 5, cfg.vocab)
    ref = RefEngine(tree, ref_cfg, batch_slots=2, max_len=48, eos_token=eos)
    for rid, prompt, n_new in reqs:
        ref.submit(RefRequest(rid, prompt.copy(), max_new_tokens=n_new))
    want = _drain(ref, len(reqs))
    with set_backend(device="cpu"):
        eng = ServeEngine(params, cfg, batch_slots=2, max_len=48, eos_token=eos)
        for rid, prompt, n_new in reqs:
            eng.submit(Request(rid, prompt.copy(), max_new_tokens=n_new))
        dak.reset_counts()
        got = _drain(eng, len(reqs))
    assert len(want) == len(reqs)
    assert got == want
    if eos == -1:
        assert {rid: len(toks) for rid, toks in got.items()} == {
            rid: n for rid, _, n in reqs
        }
    assert dak.COUNTS["plain"] > 0  # the decode path ran K5's plain version


def test_engine_matches_offline_greedy_decode():
    """Continuous-batching output == a greedy rollout through the step
    makers (batched prefill, then decode), as tests/test_serve.py asks
    of the reference."""
    _, (params, cfg) = _models("qwen3-32b", seed=3)
    prompt = np.array([5, 7, 9, 2], np.int32)
    with set_backend(device="cpu"):
        prefill_step = make_prefill_step(cfg, max_len=64)
        decode = make_decode_step(cfg)
        logits, cache = prefill_step(params, {"tokens": torch.from_numpy(prompt)[None]})
        offline = []
        tok = int(logits[0, 0].argmax())
        for _ in range(6):
            offline.append(tok)
            logits, cache = decode(params, torch.tensor([[tok]], dtype=torch.int32), cache)
            tok = int(logits[0, 0].argmax())
        eng = ServeEngine(params, cfg, batch_slots=2, max_len=64, eos_token=-1)
        eng.submit(Request(0, prompt, max_new_tokens=6))
        done = _drain(eng, 1)
    assert done[0] == offline


def test_engine_runs_out_of_cache_as_the_reference_does():
    """A slot is not rewound when a request leaves it (the reference's
    behaviour, kept): later requests on it run past the cache, where the
    masked write writes nothing, and finish at ``max_len - 1``."""
    (tree, ref_cfg), (params, cfg) = _models("qwen1.5-4b", seed=5)
    rng = np.random.default_rng(2)
    reqs = [(rid, rng.integers(1, cfg.vocab, 6).astype(np.int32), 6) for rid in range(4)]
    ref = RefEngine(tree, ref_cfg, batch_slots=1, max_len=20, eos_token=-1)
    for rid, prompt, n_new in reqs:
        ref.submit(RefRequest(rid, prompt, max_new_tokens=n_new))
    want = _drain(ref, len(reqs))
    with set_backend(device="cpu"):
        eng = ServeEngine(params, cfg, batch_slots=1, max_len=20, eos_token=-1)
        for rid, prompt, n_new in reqs:
            eng.submit(Request(rid, prompt, max_new_tokens=n_new))
        got = _drain(eng, len(reqs))
        assert int(eng._pos[0]) > 20
    assert got == want


@pytest.mark.parametrize("policy", ["wf", "wf_torch"])
def test_router_routes_as_the_reference(policy):
    ref = RefRouter(4, tokens_per_step=100)
    rng = np.random.default_rng(0)
    with set_backend(device="cpu"):
        port = ReplicaRouter(4, tokens_per_step=100, policy=policy)
        for step in range(30):
            n = int(rng.integers(1, 400))
            eligible = None if step % 3 else tuple(sorted(rng.choice(4, 2, replace=False)))
            assert port.route(n, eligible) == ref.route(n, eligible)
            np.testing.assert_array_equal(port.queued, ref.queued)
            if step % 2:
                port.drain()
                ref.drain()
        assert sum(port.route(350).values()) == 350


def test_routed_serve_pool_places_and_finishes_as_the_reference():
    (tree, ref_cfg), (params, cfg) = _models("qwen1.5-4b", seed=0)
    ref_pool = RefPool(
        {i: RefEngine(tree, ref_cfg, batch_slots=2, max_len=64, eos_token=-1)
         for i in range(2)},
        RefRouter(2, tokens_per_step=8),
    )
    ref_replicas = [
        ref_pool.submit(RefRequest(i, np.array([3, 4, 5], np.int32), max_new_tokens=3))
        for i in range(4)
    ]
    ref_done = []
    for _ in range(30):
        ref_done += ref_pool.step()
        if len(ref_done) == 4 and not ref_pool.busy():
            break
    with set_backend(device="cpu"):
        engines = {
            i: ServeEngine(params, cfg, batch_slots=2, max_len=64, eos_token=-1)
            for i in range(2)
        }
        pool = RoutedServePool(engines, ReplicaRouter(2, tokens_per_step=8))
        replicas = [
            pool.submit(Request(i, np.array([3, 4, 5], np.int32), max_new_tokens=3))
            for i in range(4)
        ]
        assert set(replicas) == {0, 1}  # WF spreads the four equal requests
        assert replicas == ref_replicas
        assert pool.busy()
        done = []
        for _ in range(30):
            done += pool.step()
            if len(done) == 4 and not pool.busy():
                break
    assert {r.request_id for r in done} == {0, 1, 2, 3}
    assert not pool.busy()
    assert {r.request_id: r.generated for r in done} == {
        r.request_id: r.generated for r in ref_done
    }
    with pytest.raises(ValueError, match="span"):
        RoutedServePool({3: engines[0]}, ReplicaRouter(2))


def test_launcher_serves_the_smoke_config_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--smoke", "--device", "cpu", "--requests", "2", "--max-new", "3"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("req 0:") and lines[1].startswith("req 1:")
    assert lines[-1].startswith("served 2 requests / 6 tokens")
    assert lines[-1].endswith("cpu)")
