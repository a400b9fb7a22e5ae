"""The partitioned strategy (``parallel/partition.py``) against the plain
math, the port's single-device step and the reference's sharded step, on
the CPU.

- With a group of one (or ``None``) every ``model``-axis operator is the
  identity, and the strategy rule sends every family's train, prefill
  and decode steps to ``"partitioned"`` but Whisper's.
- On 4 ``gloo`` ranks (``tests/torch_parallel_ranks.py``, task
  ``partition``), a (1, 4) mesh's ``model`` group: ``copy_in``,
  ``reduce_out``, ``vocab_embed`` and ``vocab_xent`` (outputs and
  gradients), and ``softmax_combine`` of K5's partials (an empty shard
  among them), against the plain ones in float32 within 1e-6.
- The partitioned train step on (2, 2) and (1, 4), 2 steps, against the
  port's single-device step within PR 25's tolerances (loss 1e-4,
  parameters 5e-4): heads that divide the ``model`` extent, heads that
  do not (attention replicated on ``model``), 2 KV heads shared over 4
  ranks, the per-head norms, the VLM patch prefix.
- The partitioned prefill: each rank's logits are its vocabulary range
  of the single-device prefill's, its cache its KV heads.
- The same step from the reference's initial parameters against the
  reference's ``jax.jit(make_train_step(...), in_shardings=...)`` on its
  (2, 2) CPU mesh (a subprocess with 4 host devices, started with the
  ranks).
- The partition factor, ranks x per-rank FLOPs / one device's FLOPs:
  the port's (``FlopCounterMode``) within 10 % of the reference's
  (``compiled.cost_analysis()`` with and without ``in_shardings``) on
  (2, 2) and (1, 4).  The gathered step's was 2 on (2, 2) and 4 on
  (1, 4): each rank ran its data shard's whole model.
- The dry run in a fake (2, 2) world (``launch/dryrun.py``): a small
  dense train cell's partitioned peak lies below the gathered step's by
  at least the gathered parameters' bytes, and its collective calls
  equal a hand count (``tests/torch_dryrun_cases.py``); the same for a
  small dense decode cell.
- The partitioned decode (``Partitioned.decode`` through
  ``step_fn_for``'s step): a one-device prefill, its cache cut by
  ``cache_sharding`` (the sequence on ``model``), its rows set back to
  positions spread over the cache (writes landing on every rank, one row
  crossing from a shard into the next), then 4 steps on (2, 2) and
  (1, 4) in the 7 cases above: each rank's logits its rows' vocabulary
  range of ``decode_step``'s within 1e-4, its cache blocks the one
  device's (outside the written rows bit for bit); on (2, 2) the
  reference's ``jax.jit(decode_step, in_shardings=(param_sharding,
  batch_sharding, cache_sharding))`` within 1e-4; the partition factor
  within 10 % of XLA's.
- The MoE families (``parallel/experts.py``) and the Mamba2 and Zamba2
  families (``parallel/ssm.py``: the SSD heads split on ``model``, or the
  mixer replicated there at 6 heads on 4; Zamba2's shared block by the
  dense rules) through the same train, prefill and decode checks, a
  Mamba2 state bit-equal over the ``model`` ranks; on (2, 2) against the
  reference's jitted sharded steps (the SSM steps' parameters within
  1e-4); their partition factors; fake (2, 2) dry runs against hand
  counts.
- The decode's K/V layouts where the sequence does not lie on ``model``
  (the KV heads on ``model``; the rows whole with the sequence on
  ``data``) against ``decode_step``, and the head_dim layout routed to
  the gathered decode.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import init_params as ref_init_params
from repro_torch.backend import set_backend
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import reference_leaf
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.kernels import decode_attention as dak
from repro_torch.models import decode_step, prefill
from repro_torch.models.ffn import drop_counts, reset_drop_counts
from repro_torch.models.ssm import _dims as ssm_dims
from repro_torch.parallel import AbstractMesh, cache_sharding, partition, placements
from repro_torch.parallel.ssm import ssm_mode
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.step import _sharded_train_step

import torch_dryrun_cases as dry_cases
import torch_parallel_ranks as ranks

LOSS_TOL, PARAM_TOL = 1e-4, 5e-4  # PR 25's (the reference's test_distributed limits)
OP_TOL = 1e-6
FACTOR_TOL = 0.10

REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.models import decode_step, prefill
from repro.parallel import batch_sharding, cache_sharding, compat, param_sharding
from repro.train import AdamWConfig, make_train_step, train_state_init
from repro.train.optim import adamw_init

out = sys.argv[1]
opt = AdamWConfig(lr=1e-2, warmup_steps=1, eps=1.0, moment_dtype="float32")
batch = {k: jnp.asarray(v) for k, v in np.load(out + "/batch.npz").items()}

def unflatten(arrays):
    tree = {}
    for key, v in arrays.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return tree

def flops(compiled):
    ca = compiled.cost_analysis()
    return float((ca[0] if isinstance(ca, list) else ca)["flops"])

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)

def sharded(cfg, state, mesh):
    st = {"params": param_sharding(mesh, state["params"]),
          "opt": {"m": param_sharding(mesh, state["opt"]["m"]),
                  "v": param_sharding(mesh, state["opt"]["v"]),
                  "step": NamedSharding(mesh, P())}}
    return jax.jit(make_train_step(cfg, opt), in_shardings=(st, batch_sharding(mesh, batch)))

res = {}
for name, heads in (("dense", None), ("odd_heads", 5)):
    cfg = get_smoke_config("qwen1.5-4b")
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    abstract = jax.eval_shape(lambda k: train_state_init(k, cfg, opt).as_dict(),
                              jax.random.PRNGKey(0))
    single = jax.jit(make_train_step(cfg, opt)).lower(abstract, batch).compile()
    res[name + "_single"] = flops(single)
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_of(shape)
        with compat.set_mesh(mesh):
            c = sharded(cfg, abstract, mesh).lower(abstract, batch).compile()
        res[f"{name}_{shape[0]}x{shape[1]}"] = flops(c)

cfg = get_smoke_config("qwen1.5-4b")
params = unflatten(dict(np.load(out + "/ref_init_dense_2x2.npz")))
state = {"params": params, "opt": adamw_init(opt, params)}
mesh = mesh_of((2, 2))
losses = []
with compat.set_mesh(mesh):
    step = sharded(cfg, state, mesh)
    for _ in range(2):
        state, m = step(state, batch)
        state = jax.tree.map(np.asarray, state)
        losses.append(float(m["loss"]))
res["losses"] = np.asarray(losses)
for path, leaf in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
    res["param/" + "/".join(p.key for p in path)] = np.asarray(leaf)

# the decode: one-device prefill, the rows set back, then the jitted
# decode_step with the cache as cache_sharding places it
dec = dict(np.load(out + "/decode.npz"))
_, cache = prefill(params, cfg, {"tokens": jnp.asarray(dec["prompt"])},
                   max_len=int(dec["length"]))
cache["pos"] = jnp.asarray(dec["pos"])
decode = lambda p, t, c: decode_step(p, cfg, t, c)
tok = jnp.asarray(dec["tokens"][:, :1])
res["decode_single"] = flops(jax.jit(decode).lower(params, tok, cache).compile())
for shape in ((2, 2), (1, 4)):
    mesh = mesh_of(shape)
    with compat.set_mesh(mesh):
        step = jax.jit(decode, in_shardings=(param_sharding(mesh, params),
                                             batch_sharding(mesh, {"tokens": tok})["tokens"],
                                             cache_sharding(mesh, cache)))
        res[f"decode_{shape[0]}x{shape[1]}"] = flops(step.lower(params, tok, cache).compile())
        if shape == (2, 2):
            logits, c = [], cache
            for i in range(dec["tokens"].shape[1]):
                lg, c = step(params, jnp.asarray(dec["tokens"][:, i:i + 1]), c)
                logits.append(np.asarray(lg))
            res["decode_logits"] = np.stack(logits)
np.savez(out + "/reference_partition.npz", **res)
"""

# the MoE and SSM cases' reference side, one subprocess a family (beside
# its rank group): for each
# case the train and decode steps' FLOPs on one device and on its mesh (the
# partition factor) and, for a case held against the reference, 2 train
# steps and 4 decode steps on (2, 2) from its initial parameters
REFERENCE_FAMILIES = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.models import decode_step, init_params, prefill
from repro.parallel import batch_sharding, cache_sharding, compat, param_sharding
from repro.train import AdamWConfig, make_train_step, train_state_init
from repro.train.optim import adamw_init

out, cases = sys.argv[1], json.loads(sys.argv[2])
opt = AdamWConfig(lr=1e-2, warmup_steps=1, eps=1.0, moment_dtype="float32")

def unflatten(arrays):
    tree = {}
    for key, v in arrays.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return tree

def flops(compiled):
    ca = compiled.cost_analysis()
    return float((ca[0] if isinstance(ca, list) else ca)["flops"])

singles = {}  # one device's FLOPs, once a config (two cases may share one)
for name, case in cases.items():
    key = json.dumps([case["arch"], case["overrides"], case["moe"]])
    cfg = dataclasses.replace(get_smoke_config(case["arch"]), **case["overrides"])
    if case["moe"]:
        dispatch, cf, coef, *experts = case["moe"]
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch, capacity_factor=cf, router_aux_coef=coef))
    mesh = jax.make_mesh(tuple(case["mesh"]), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    batch = {k: jnp.asarray(v) for k, v in np.load(f"{out}/batch_{name}.npz").items()}
    dec = dict(np.load(f"{out}/decode_{name}.npz"))
    res = {}
    abstract = jax.eval_shape(lambda k: train_state_init(k, cfg, opt).as_dict(),
                              jax.random.PRNGKey(0))

    train_step = make_train_step(cfg, opt)  # one function, so its compiles are reused

    def sharded(state):
        st = {"params": param_sharding(mesh, state["params"]),
              "opt": {"m": param_sharding(mesh, state["opt"]["m"]),
                      "v": param_sharding(mesh, state["opt"]["v"]),
                      "step": NamedSharding(mesh, P())}}
        return jax.jit(train_step, in_shardings=(st, batch_sharding(mesh, batch)))

    if key not in singles:
        singles[key] = {"train_single": flops(
            jax.jit(train_step).lower(abstract, batch).compile())}
    res["train_single"] = singles[key]["train_single"]
    with compat.set_mesh(mesh):
        res["train_mesh"] = flops(sharded(abstract).lower(abstract, batch).compile())
    prompt = {"tokens": jnp.asarray(dec["prompt"])}
    if case["reference"]:
        params = unflatten(dict(np.load(f"{out}/ref_init_{name}.npz")))
        _, cache = prefill(params, cfg, prompt, max_len=int(dec["length"]))
    else:  # only counted: the parameters' and the cache's shapes
        params = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda p: prefill(p, cfg, prompt, max_len=int(dec["length"]))[1],
                               params)
    cache["pos"] = jnp.asarray(dec["pos"])
    decode = lambda p, t, c: decode_step(p, cfg, t, c)
    tok = jnp.asarray(dec["tokens"][:, :1])
    if "decode_single" not in singles[key]:
        singles[key]["decode_single"] = flops(jax.jit(decode).lower(params, tok, cache).compile())
    res["decode_single"] = singles[key]["decode_single"]
    with compat.set_mesh(mesh):
        step = jax.jit(decode, in_shardings=(param_sharding(mesh, params),
                                             batch_sharding(mesh, {"tokens": tok})["tokens"],
                                             cache_sharding(mesh, cache)))
        res["decode_mesh"] = flops(step.lower(params, tok, cache).compile())
        if case["reference"]:
            logits, c = [], cache
            for i in range(dec["tokens"].shape[1]):
                lg, c = step(params, jnp.asarray(dec["tokens"][:, i:i + 1]), c)
                c = jax.device_put(c, cache_sharding(mesh, c))  # a state's own layout back
                logits.append(np.asarray(lg))
            res["decode_logits"] = np.stack(logits)
    if case["reference"]:  # the state built outside the mesh's scope, as the dense case's
        state = {"params": params, "opt": adamw_init(opt, params)}
        losses = []
        with compat.set_mesh(mesh):
            train = sharded(state)
            for _ in range(2):
                state, m = train(state, batch)
                state = jax.tree.map(np.asarray, state)
                losses.append(float(m["loss"]))
        res["losses"] = np.asarray(losses)
        for path, leaf in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
            res["param/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    np.savez(f"{out}/reference_{name}.npz", **res)
"""
SSM_FAMILIES = ("mamba2", "zamba2")
FAMILY_FACTOR_CASES = [c for c in ranks.FACTOR_CASES if not c.startswith("dense_")]
MOE_FACTOR_CASES = [c for c in FAMILY_FACTOR_CASES if ranks.PARTITION_CASES[c][3]]
MOE_REFERENCE_CASES = [c for c in ranks.REFERENCE_CASES if ranks.PARTITION_CASES[c][3]]
SSM_FACTOR_CASES = [c for c in FAMILY_FACTOR_CASES
                    if ranks.partition_config(c).block_pattern in SSM_FAMILIES]
SSM_REFERENCE_CASES = [c for c in ranks.REFERENCE_CASES
                       if ranks.partition_config(c).block_pattern in SSM_FAMILIES]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _reference_process(out, script: str, *args: str) -> subprocess.Popen:
    """The reference's side in a subprocess on a 4-device CPU mesh."""
    return subprocess.Popen(
        [sys.executable, "-c",
         "import os\n"
         'os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"\n'
         + textwrap.dedent(script), str(out), *args],
        env=ranks.subprocess_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _save_reference_inputs(out, name: str) -> dict:
    """A case's reference-side inputs: its initial parameters (for a case
    held against the reference), batch and decode inputs; the case's
    entry for ``REFERENCE_FAMILIES``."""
    arch, overrides, mesh, moe = ranks.PARTITION_CASES[name]
    cfg = ranks.partition_config(name)
    if name in ranks.REFERENCE_CASES:
        ref_cfg = dataclasses.replace(ref_smoke_config(arch), **(overrides or {}))
        if moe is not None:
            ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
                ref_cfg.moe, n_experts=cfg.moe.n_experts))
        tree = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
        np.savez(out / f"ref_init_{name}.npz",
                 **{"/".join(p.key for p in path): np.asarray(leaf)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]})
    batch = ranks.partition_batch(cfg)
    np.savez(out / f"batch_{name}.npz", **{k: v.numpy().astype(np.int32) for k, v in batch.items()})
    prompt, pos, tokens = ranks.decode_inputs(cfg)
    np.savez(out / f"decode_{name}.npz", prompt=prompt["tokens"].numpy().astype(np.int32),
             pos=pos.numpy(), tokens=tokens.numpy().astype(np.int32),
             length=ranks.decode_len(cfg))
    return {"arch": arch, "overrides": overrides or {}, "mesh": list(mesh),
            "moe": list(moe) if moe else None, "reference": name in ranks.REFERENCE_CASES}


def _operator_inputs(rng) -> dict:
    logits = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    targets = rng.integers(0, 16, (2, 5))
    targets[0, 3:] = -1
    lse = (rng.normal(size=(4, 3, 4)) * 4).astype(np.float32)
    lse[2] = -np.inf  # a rank whose shard holds no key of any row
    lse[1, 0] = -np.inf
    return {"x": rng.normal(size=(6, 5)).astype(np.float32),
            "w": rng.normal(size=(4, 6, 5)).astype(np.float32),
            "xs": rng.normal(size=(4, 6, 5)).astype(np.float32),
            "table": rng.normal(size=(16, 3)).astype(np.float32),
            "tokens": rng.integers(0, 16, (2, 5)),
            "c": rng.normal(size=(2, 5, 3)).astype(np.float32),
            "logits": logits, "targets": targets,
            "g": rng.normal(size=(2, 5)).astype(np.float32),
            "att_out": rng.normal(size=(4, 3, 4, 8)).astype(np.float32),
            "att_lse": lse}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4 gloo ranks (task ``partition``: the dense and MoE
    cases) and the reference's 4-device subprocesses (the dense cases',
    and one for each MoE family), started together."""
    out = tmp_path_factory.mktemp("partition")
    np.savez(out / "operators.npz", **_operator_inputs(np.random.default_rng(31)))
    names = [n for n in dict.fromkeys(ranks.REFERENCE_CASES + ranks.FACTOR_CASES)
             if n not in ranks.SSM_CASES]
    moe = {name: _save_reference_inputs(out, name) for name in names}
    batch = ranks.step_batch("dense", ref_smoke_config("qwen1.5-4b").vocab)
    np.savez(out / "batch.npz", **{k: v.numpy().astype(np.int32) for k, v in batch.items()})
    (out / "decode.npz").write_bytes((out / "decode_dense_2x2.npz").read_bytes())
    families = {}
    for name in MOE_FACTOR_CASES:
        families.setdefault(moe[name]["arch"], {})[name] = moe[name]
    references = [_reference_process(out, REFERENCE)] + [
        _reference_process(out, REFERENCE_FAMILIES, json.dumps(cases))
        for cases in families.values()]
    ranks.wait_all([*ranks.start_ranks("partition", 4, out), *references])
    return out


@pytest.fixture(scope="module")
def ssm_runs(tmp_path_factory):
    """The port's 4 gloo ranks (task ``partition_ssm``: the Mamba2 and
    Zamba2 cases and the decode layouts) and the reference's 4-device
    subprocesses, one for each SSM family, started together: a group of
    its own, so that each group keeps within ``GROUP_TIMEOUT_S``."""
    out = tmp_path_factory.mktemp("partition_ssm")
    families: dict = {}
    for name in ranks.SSM_CASES:
        case = _save_reference_inputs(out, name)
        families.setdefault(case["arch"], {})[name] = case
    ranks.wait_all([*ranks.start_ranks("partition_ssm", 4, out),
                    *(_reference_process(out, REFERENCE_FAMILIES, json.dumps(cases))
                      for cases in families.values())])
    return out


def _dir(request, name: str):
    """The folder of the rank group that ran case ``name`` (a partition
    case, or a decode layout case)."""
    apart = name in ranks.SSM_CASES or name in ranks.LAYOUT_CASES
    return request.getfixturevalue("ssm_runs" if apart else "runs")


def _single_device(cfg, batch, steps=ranks.STEPS):
    """The port's own single-device step: metrics, final parameters and
    the first step's FLOPs."""
    with set_backend(device="cpu"):
        state = ranks.initial_state(cfg)
        step = make_train_step(cfg, AdamWConfig(**ranks.OPT))
        st, metrics, flops = state.as_dict(), [], None
        for i in range(steps):
            counter = FlopCounterMode(display=False)
            with counter:
                st, m = step(st, batch)
            flops = flops or counter.get_total_flops()
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {n: p.detach() for n, p in st["params"].named_parameters()}, flops


# ---- in-process -------------------------------------------------------------------


def test_operators_are_the_identity_on_a_group_of_one():
    x = torch.randn(3, 4, requires_grad=True)
    assert partition.copy_in(x, None) is x and partition.reduce_out(x, None) is x
    table, tokens = torch.randn(10, 4), torch.tensor([[1, 9, 0]])
    assert torch.equal(partition.vocab_embed(table, tokens, 0, None), table[tokens])
    logits, targets = torch.randn(2, 3, 10), torch.tensor([[1, -1, 4], [0, 9, -1]])
    want = torch.logsumexp(logits, -1) - logits.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    want = torch.where(targets >= 0, want, torch.zeros_like(want))
    assert torch.equal(partition.vocab_xent(logits, targets, 0, None), want)
    block = torch.randn(4, 2)
    steps = (partition.Step(None, 1, 0, 0, "avg"), partition.Step(None, 1, 0, None, "sum"))
    assert partition.use(block, steps) is block
    out, lse = torch.randn(2, 3, 4), torch.randn(2, 3)
    assert partition.softmax_combine(out, lse, None) is out


@pytest.mark.parametrize("arch", ARCHS)
def test_the_rule_partitions_the_dense_train_and_prefill_steps_only(arch):
    """Every family's train, prefill and decode steps are partitioned (the
    dense decoder's since PR 29-30, the MoE families' since PR 31, Mamba2's
    and Zamba2's since PR 32) but Whisper's, which are gathered; the
    attention and SSM modes on the production meshes' model axis of 16."""
    cfg = get_config(arch)
    split = cfg.block_pattern != "encdec"
    for kind in ("train", "prefill", "decode"):
        want = "partitioned" if split else "gathered"
        assert partition.strategy(cfg, kind) == want
    if split:
        heads = {"qwen2-72b", "qwen3-32b", "llava-next-mistral-7b", "qwen3-moe-235b-a22b",
                 "deepseek-v3-671b", "zamba2-2.7b"}
        if cfg.block_pattern != "mamba2":  # attention-free
            assert partition.attention_mode(cfg, 16) == ("heads" if arch in heads
                                                         else "replicated")
        if cfg.block_pattern in SSM_FAMILIES:  # zamba2's 80 SSD heads; mamba2-130m's 24
            assert ssm_mode(cfg, 16) == ("heads" if arch == "zamba2-2.7b" else "replicated")
    else:
        with pytest.raises(ValueError, match="not partitioned"):
            partition.Partitioned(cfg, None)


# ---- the model-axis operators on 4 gloo ranks ------------------------------------


def test_model_axis_operators_equal_the_plain_ones(runs):
    a = {k: torch.from_numpy(v) for k, v in np.load(runs / "operators.npz").items()}
    table = a["table"].clone().requires_grad_(True)
    emb = torch.nn.functional.embedding(a["tokens"], table)
    (emb * a["c"]).sum().backward()
    logits = a["logits"].clone().requires_grad_(True)
    valid = a["targets"] >= 0
    picked = logits.gather(-1, a["targets"].clamp(min=0)[..., None])[..., 0]
    lz = torch.logsumexp(logits, -1) - picked
    nll = torch.where(valid, lz, torch.zeros_like(lz))
    (nll * a["g"]).sum().backward()
    for r in range(4):
        got = torch.load(runs / f"operators_rank{r}.pt")
        close = lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=OP_TOL)  # noqa: E731
        close(got["copy_in"], a["x"])
        close(got["copy_in_grad"], a["w"].sum(0))
        close(got["reduce_out"], a["xs"].sum(0))
        close(got["reduce_out_grad"], a["w"][0])
        close(got["embed"], emb.detach())
        close(got["embed_grad"], table.grad[r * 4:(r + 1) * 4])
        close(got["xent"], nll.detach())
        close(got["xent_grad"], logits.grad[..., r * 4:(r + 1) * 4])
        close(got["combine"], dak.combine_partials(a["att_out"], a["att_lse"]))


# ---- the partitioned train step and prefill ---------------------------------------


@pytest.mark.parametrize("name", list(ranks.PARTITION_CASES))
def test_partitioned_step_equals_the_single_device_step(request, name):
    got = torch.load(_dir(request, name) / "partition_rank0.pt")[name]
    cfg = ranks.partition_config(name)
    want_metrics, want, _ = _single_device(cfg, ranks.partition_batch(cfg))
    for g, w in zip(got["metrics"], want_metrics):
        assert set(g) == set(w)
        assert abs(g["loss"] - w["loss"]) < LOSS_TOL
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"]
    flat = {".".join(p): t for p, t in _flat(got["params"])}
    assert set(flat) == set(want)
    for n, w in want.items():
        assert float((flat[n] - w).abs().max()) < PARAM_TOL, n


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _prefill_share(cfg, path: tuple, want: torch.Tensor, b: slice, m: int, model: int):
    """Model rank ``m`` 's share of rows ``b`` of the one-device prefill's
    cache leaf at ``path``: KV heads by attention mode (MLA's latent
    whole); a Mamba2 state by SSM mode, its heads' ``ssm`` and its ``x`` and
    ``B`` / ``C`` channels of ``conv`` in ``"heads"`` mode, else whole."""
    leaf = path[-1]
    if leaf in ("conv", "ssm"):
        if ssm_mode(cfg, model) != "heads":
            return want[:, b]
        d_in, nh, _, _ = ssm_dims(cfg)
        if leaf == "ssm":
            return want[:, b, m * nh // model:(m + 1) * nh // model]
        w = d_in // model
        return torch.cat([want[:, b, :, m * w:(m + 1) * w], want[:, b, :, d_in:]], dim=-1)
    if cfg.block_pattern == "mla_moe" or partition.attention_mode(cfg, model) != "heads":
        return want[:, b]
    per = cfg.n_kv_heads // model or 1  # the KV heads this rank's query heads use
    first = m * cfg.n_kv_heads // model if cfg.n_kv_heads >= model else (
        m // (model // cfg.n_kv_heads))
    return want[:, b, first:first + per]


@pytest.mark.parametrize("name", list(ranks.PARTITION_CASES))
def test_partitioned_prefill_is_each_ranks_share_of_the_single_device_prefill(request, name):
    cfg = ranks.partition_config(name)
    data, model = ranks.PARTITION_CASES[name][2]
    batch = ranks.partition_batch(cfg)
    prompt = {k: v[:, :ranks.PREFILL_LEN] for k, v in batch.items() if k != "targets"}
    if "patches" in batch:
        prompt["patches"] = batch["patches"]
    with set_backend(device="cpu"):
        logits, cache = prefill(ranks.initial_state(cfg).params, cfg, prompt)
    rows, vocab = logits.shape[0] // data, cfg.vocab // model
    heads = (partition.attention_mode(cfg, model) == "heads")
    for r in range(4):
        got = torch.load(_dir(request, name) / f"partition_rank{r}.pt")["prefill"][name]
        d, m = divmod(r, model)
        b = slice(d * rows, (d + 1) * rows)
        assert got["attention"] == ("heads" if heads else "replicated")
        torch.testing.assert_close(got["logits"], logits[b, :, m * vocab:(m + 1) * vocab],
                                   rtol=0, atol=1e-5)
        assert set(got) - {"logits", "pos", "attention", "drops"} == set(cache["layers"])
        for path, want in _flat(cache["layers"]):
            torch.testing.assert_close(_at(got, path), _prefill_share(cfg, path, want, b, m,
                                                                      model),
                                       rtol=0, atol=1e-5)
        assert torch.equal(got["pos"], cache["pos"][b])


def test_partitioned_step_equals_the_references_sharded_step(runs):
    ref = dict(np.load(runs / "reference_partition.npz"))
    got = torch.load(runs / "partition_rank0.pt")["reference/dense_2x2"]
    losses = [m["loss"] for m in got["metrics"]]
    assert np.abs(np.asarray(losses) - ref["losses"]).max() < LOSS_TOL
    for path, t in _flat(got["params"]):
        key, index = reference_leaf(".".join(path))
        want = ref["param/" + "/".join(key)]
        want = want if index is None else want[index]
        assert np.abs(t.numpy() - want).max() < PARAM_TOL, path


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_partition_factor_is_the_references(runs, mesh):
    """ranks x per-rank FLOPs / one device's FLOPs: the port's within 10 %
    of XLA's on the same config and mesh (the gathered step's: 2 on
    (2, 2), 4 on (1, 4))."""
    ref = dict(np.load(runs / "reference_partition.npz"))
    name = f"dense_{mesh}"
    cfg = ranks.partition_config(name)
    _, _, single = _single_device(cfg, ranks.partition_batch(cfg), steps=1)
    port = sum(torch.load(runs / f"partition_rank{r}.pt")["flops"][name]
               for r in range(4)) / single
    want = 4 * ref[f"dense_{mesh}"] / ref["dense_single"]
    assert abs(port - want) <= FACTOR_TOL * want, (port, want)
    assert port < 1.5  # the model axis splits the work, not repeats it


# ---- the dry run in a fake (2, 2) world --------------------------------------------


def test_dry_run_partitioned_cell_against_gathered_and_a_hand_count():
    cfg = get_config("qwen3-32b").scaled(n_layers=2)
    shape = ShapeSpec("small_train", "train", 64, 4)
    opt = AdamWConfig()
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        sh = dryrun.shardings_for(mesh, cfg, shape, opt)
        fn, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, part = dryrun.count_step(fn, args)
        gathered = _sharded_train_step(cfg, opt, 1, True, mesh)
        _, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, full = dryrun.count_step(gathered, args)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in specs.param_specs(cfg).parameters())
    assert part.peak_bytes <= full.peak_bytes - param_bytes
    assert part.collective_ops == dry_cases.partitioned_collectives(cfg, (2, 2))
    assert part.flops * 1.5 < full.flops


def test_dry_run_partitioned_decode_cell_against_gathered_and_a_hand_count():
    """A small dense decode cell (Qwen3-32B's width, 2 layers, 4 rows x 64
    positions) in a fake (2, 2) world: the partitioned step's peak below
    the gathered step's by at least the gathered parameters' bytes, its
    collective calls the hand count, its FLOPs well under the gathered
    step's, K5 launched in its partial mode once a layer."""
    cfg = get_config("qwen3-32b").scaled(n_layers=2)
    shape = ShapeSpec("small_decode", "decode", 64, 4)
    opt = AdamWConfig()
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        sh = dryrun.shardings_for(mesh, cfg, shape, opt)
        fn, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, part = dryrun.count_step(fn, args)
        _, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, full = dryrun.count_step(specs._gathered_step(cfg, "decode", mesh), args)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in specs.param_specs(cfg).parameters())
    assert part.peak_bytes <= full.peak_bytes - param_bytes
    assert part.collective_ops == dry_cases.partitioned_decode_collectives(cfg, (2, 2))
    assert part.flops * 1.5 < full.flops
    assert part.kernels["decode_attention_partial"]["calls"] == cfg.n_layers
    assert "decode_attention" not in part.kernels


def test_partitioned_decode_refuses_a_cache_not_split_by_the_sequence(ssm_runs):
    """A cache of 63 positions on a (2, 2) mesh: ``cache_sharding`` puts its
    KV heads on ``model`` (63 does not divide by 2).  The partitioned
    decode refused that layout until PR 32; it takes it now: on 4 ``gloo``
    ranks (the layout case ``dense_heads_2x2``) its 4 steps equal the
    single-device decode (:func:`_check_decode`), and in a fake (2, 2)
    world at Qwen3-32B's width each rank projects its heads' columns and
    attends over its KV heads in K5's whole-cache mode, one launch a
    layer, with no partial mode, no softmax combine and the hand count's
    collectives."""
    cfg = get_config("qwen3-32b").scaled(n_layers=2)
    shape = ShapeSpec("odd_decode", "decode", 63, 4)
    opt = AdamWConfig()
    _check_layout_case(ssm_runs, "dense_heads_2x2")
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        sh = dryrun.shardings_for(mesh, cfg, shape, opt)
        assert sh[2]["layers"]["k"] == (None, "data", "model", None, None)
        assert partition.decode_strategy(cfg, mesh, sh[2]) == "partitioned"
        fn, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, part = dryrun.count_step(fn, args)
    assert part.kernels["decode_attention"]["calls"] == cfg.n_layers
    assert "decode_attention_partial" not in part.kernels
    assert part.collective_ops == dry_cases.partitioned_decode_collectives(cfg, (2, 2),
                                                                           layout="heads")


def test_a_cache_with_its_head_dim_on_model_takes_the_gathered_decode():
    """Five KV heads of 16 wide and 63 positions on (1, 4): neither the
    sequence nor the heads divide by 4, so ``cache_sharding`` puts the
    head_dim on ``model``; :func:`decode_strategy` sends that layout (no
    published cell's) to the gathered decode, which ``step_fn_for`` builds:
    its step runs K5's whole mode over all heads, and its collectives are
    the gathered step's."""
    cfg = ranks.partition_config("odd_heads_1x4")
    shape = ShapeSpec("head_dim_decode", "decode", 63, 4)
    opt = AdamWConfig()
    with dryrun.fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"), "cpu")
        sh = dryrun.shardings_for(mesh, cfg, shape, opt)
        assert sh[2]["layers"]["k"] == (None, "data", None, None, "model")
        assert partition.decode_strategy(cfg, mesh, sh[2]) == "gathered"
        fn, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, got = dryrun.count_step(fn, args)
        _, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, gathered = dryrun.count_step(specs._gathered_step(cfg, "decode", mesh), args)
    assert got.collective_ops == gathered.collective_ops
    assert got.kernels["decode_attention"]["calls"] == cfg.n_layers
    for shape_ in (ShapeSpec("seq_decode", "decode", 64, 4), shape):  # the rule, alone
        cache = specs.cache_specs(cfg, 4, shape_.seq_len)
        mesh = AbstractMesh((1, 4), ("data", "model"))
        want = "partitioned" if shape_.seq_len == 64 else "gathered"
        assert partition.decode_strategy(cfg, mesh, cache_sharding(mesh, cache)) == want


# ---- the partitioned decode ------------------------------------------------------


def _single_decode(cfg, count_flops: bool = False, inputs: tuple | None = None,
                   length: int | None = None):
    """``decode_step`` on one device from the cache the ranks start from
    (``inputs``: prompt, positions and tokens; default ``decode_inputs``):
    each step's logits, the final cache, the first step's FLOPs."""
    with set_backend(device="cpu"):
        params = ranks.initial_state(cfg).params
        prompt, pos, tokens = inputs or ranks.decode_inputs(cfg)
        cache = ranks.single_prefill(params, cfg, prompt, pos, length)
        logits, flops = [], None
        for i in range(ranks.DECODE_STEPS):
            counter = FlopCounterMode(display=False)
            with counter:
                out, cache = decode_step(params, cfg, tokens[:, i:i + 1], cache)
            flops = flops or counter.get_total_flops()
            logits.append(out)
    return logits, cache, flops


def _block(full: torch.Tensor, spec: tuple, coord: tuple, sizes: tuple) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coord`` of a (data, model)
    mesh of ``sizes`` holds under ``spec``."""
    out = full
    for dim, axes in enumerate(spec):
        for a in (() if axes is None else (axes,) if isinstance(axes, str) else axes):
            i = ("data", "model").index(a)
            out = out.chunk(sizes[i], dim=dim)[coord[i]]
    return out


def _written(layers: dict, pos: torch.Tensor) -> dict:
    """Per cache leaf, the entries the decode steps write: the K/V (MLA:
    latent) rows at each row's positions ``pos .. pos + DECODE_STEPS - 1``;
    a Mamba2 state whole."""
    out = {}
    for path, full in _flat(layers):
        mask = torch.zeros(full.shape, dtype=torch.bool)
        if path[-1] in ("conv", "ssm"):
            mask[:] = True
        seq = 2 if path[-1] in ("c_kv", "k_rope") else 3  # (L, B, S, r); (L, B, Hkv, S, hd)
        for row, p in enumerate(pos.tolist()):
            for step in range(ranks.DECODE_STEPS if path[-1] not in ("conv", "ssm") else 0):
                if p + step < full.shape[seq]:
                    index = [slice(None)] * full.dim()
                    index[1], index[seq] = row, p + step
                    mask[tuple(index)] = True
        out[path] = mask
    return out


def _check_decode(got: list, want: list, cache: dict, pos: torch.Tensor, sizes: tuple):
    """Each rank's logits its rows' (split on the data axes where they
    divide, else all) vocabulary range of ``decode_step`` 's (float32,
    1e-4) at every step; each cache leaf the one device's block under
    ``cache_sharding`` (whatever its layout): the entries the steps wrote
    within 1e-5 (their projections' column blocks round otherwise), every
    other bit for bit, so each K/V row went into the block that holds its
    position and nowhere else; a Mamba2 state bit-equal over the ``model``
    ranks."""
    data, model = sizes
    specs_ = dict(_flat(cache_sharding(AbstractMesh(sizes, ("data", "model")), cache)["layers"]))
    written = _written(cache["layers"], pos)
    n = len(pos)
    rows = n // data if n % data == 0 else n
    for r in range(data * model):
        d, m = divmod(r, model)
        b = slice(d * rows, (d + 1) * rows) if rows < n else slice(None)
        assert len(got[r]["logits"]) == ranks.DECODE_STEPS
        for g, w in zip(got[r]["logits"], want):
            v = w.shape[-1] // model
            torch.testing.assert_close(g, w[b, :, m * v:(m + 1) * v], rtol=0, atol=1e-4)
        for path, full in _flat(cache["layers"]):
            block = _block(full, specs_[path], (d, m), sizes)
            mask = _block(written[path], specs_[path], (d, m), sizes)
            mine = _at(got[r], path)
            torch.testing.assert_close(mine, block, rtol=0, atol=1e-5)
            assert torch.equal(mine[~mask], block[~mask]), path
            if path[-1] in ("conv", "ssm"):
                assert torch.equal(mine, _at(got[d * model], path)), path
        assert torch.equal(got[r]["pos"], cache["pos"])


@pytest.mark.parametrize("name", list(ranks.PARTITION_CASES))
def test_partitioned_decode_equals_the_single_device_decode(request, name):
    """Each rank's logits are its rows' vocabulary range of ``decode_step``'s
    (float32, 1e-4) at every step; its K/V blocks are the one device's
    blocks (the sequence on ``model``): the rows the steps wrote within
    1e-5 (their projections' column blocks round otherwise), every other
    position bit for bit, so each row was written into the shard that
    holds its position and nowhere else; a Mamba2 state (whole on
    ``model``) its rows' within 1e-5 and bit-equal over the ``model``
    ranks."""
    cfg = ranks.partition_config(name)
    want, cache, _ = _single_decode(cfg)
    _, pos, _ = ranks.decode_inputs(cfg)
    got = [torch.load(_dir(request, name) / f"partition_decode_rank{r}.pt")[name]
           for r in range(4)]
    _check_decode(got, want, cache, pos, ranks.PARTITION_CASES[name][2])


@pytest.mark.parametrize("name", [c for c in ranks.LAYOUT_CASES if c != "dense_heads_2x2"])
def test_partitioned_decode_takes_every_kv_layout(ssm_runs, name):
    """The K/V layouts ``cache_sharding`` gives where the sequence does not
    lie on ``model``: the KV heads on ``model`` with the rows on ``data``
    (63 positions; the dense case in the test above), and the rows whole
    with the sequence on ``data`` and the heads on ``model`` (3 rows;
    Zamba2 long_500k's layout), for the dense decoder and Zamba2's shared
    block: each rank's logits and blocks as :func:`_check_decode` holds
    them."""
    _check_layout_case(ssm_runs, name)


def _check_layout_case(runs, name: str) -> None:
    """A layout case's cache laid out as its name says, and its ranks'
    decode held by :func:`_check_decode`."""
    cfg, prompt, pos, tokens, length = ranks.layout_inputs(name)
    sizes = ranks.LAYOUT_CASES[name][1]
    want, cache, _ = _single_decode(cfg, inputs=(prompt, pos, tokens), length=length)
    mesh = AbstractMesh(sizes, ("data", "model"))
    kv = cache_sharding(mesh, cache)["layers"]
    spec = (kv["attn"] if cfg.block_pattern == "zamba2" else kv)["k"]
    layout = partition.kv_layout(mesh, placements(mesh, spec))
    assert layout == partition.KVLayout("data" if "sequence_on_data" in name else None, True)
    got = [torch.load(runs / f"partition_decode_rank{r}.pt")[f"layout/{name}"]
           for r in range(4)]
    _check_decode(got, want, cache, pos, sizes)


def test_partitioned_decode_equals_the_references_sharded_decode(runs):
    ref = dict(np.load(runs / "reference_partition.npz"))["decode_logits"]
    rows, vocab = ref.shape[1] // 2, ref.shape[-1] // 2
    for r in range(4):
        got = torch.load(runs / f"partition_decode_rank{r}.pt")["reference/dense_2x2"]["logits"]
        d, m = divmod(r, 2)
        for step, g in enumerate(got):
            want = ref[step, d * rows:(d + 1) * rows, :, m * vocab:(m + 1) * vocab]
            assert np.abs(g.numpy() - want).max() < 1e-4, (r, step)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_decode_partition_factor_is_the_references(runs, mesh):
    """ranks x per-rank FLOPs / one device's FLOPs of a decode step: the
    port's within 10 % of XLA's (the gathered step's: 2 on (2, 2), 4 on
    (1, 4))."""
    ref = dict(np.load(runs / "reference_partition.npz"))
    name = f"dense_{mesh}"
    _, _, single = _single_decode(ranks.partition_config(name), count_flops=True)
    port = sum(torch.load(runs / f"partition_decode_rank{r}.pt")[name]["flops"]
               for r in range(4)) / single
    want = 4 * ref[f"decode_{mesh}"] / ref["decode_single"]
    assert abs(port - want) <= FACTOR_TOL * want, (port, want)
    assert port < 1.5


# ---- the MoE and MLA + MoE families ----------------------------------------------


def _ranks_flops(runs, name: str, decode: bool) -> float:
    """The 4 ranks' FLOPs of a case's first step, summed."""
    if decode:
        return sum(torch.load(runs / f"partition_decode_rank{r}.pt")[name]["flops"]
                   for r in range(4))
    return sum(torch.load(runs / f"partition_rank{r}.pt")["flops"][name] for r in range(4))


def _family_factor(runs, name: str, kind: str) -> tuple[float, float]:
    """The port's and XLA's partition factor of a family case's train or
    decode step: ranks x per-rank FLOPs / one device's FLOPs."""
    ref = dict(np.load(runs / f"reference_{name}.npz"))
    cfg = ranks.partition_config(name)
    if kind == "train":
        _, _, single = _single_device(cfg, ranks.partition_batch(cfg), steps=1)
    else:
        _, _, single = _single_decode(cfg, count_flops=True)
    port = _ranks_flops(runs, name, kind == "decode") / single
    want = 4 * ref[f"{kind}_mesh"] / ref[f"{kind}_single"]
    print(f"{name} {kind}: port {port:.4f}, XLA {want:.4f}")  # reprolint: disable=R008 the factors PERF.md records (pytest -s)
    return port, want


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("name", MOE_FACTOR_CASES)
def test_moe_partition_factor_is_the_references(runs, name, kind):
    """ranks x per-rank FLOPs / one device's FLOPs of a train or decode
    step of the MoE families: the port's within 10 % of XLA's, or below
    it (the gathered step routed the global batch on every rank)."""
    port, want = _family_factor(runs, name, kind)
    assert port <= (1 + FACTOR_TOL) * want, (port, want)


def _held_against_reference_train(runs, name: str, param_tol: float = PARAM_TOL) -> None:
    ref = dict(np.load(runs / f"reference_{name}.npz"))
    got = torch.load(runs / "partition_rank0.pt")[f"reference/{name}"]
    losses = [m["loss"] for m in got["metrics"]]
    assert np.abs(np.asarray(losses) - ref["losses"]).max() < LOSS_TOL
    for path, t in _flat(got["params"]):
        key, index = reference_leaf(".".join(path))
        want = ref["param/" + "/".join(key)]
        want = want if index is None else want[index]
        assert np.abs(t.numpy() - want).max() < param_tol, path


def _held_against_reference_decode(runs, name: str) -> None:
    ref = dict(np.load(runs / f"reference_{name}.npz"))["decode_logits"]
    rows, vocab = ref.shape[1] // 2, ref.shape[-1] // 2
    for r in range(4):
        got = torch.load(runs / f"partition_decode_rank{r}.pt")[f"reference/{name}"]["logits"]
        d, m = divmod(r, 2)
        for step, g in enumerate(got):
            want = ref[step, d * rows:(d + 1) * rows, :, m * vocab:(m + 1) * vocab]
            assert np.abs(g.numpy() - want).max() < 1e-4, (r, step)


@pytest.mark.parametrize("name", MOE_REFERENCE_CASES)
def test_moe_partitioned_step_equals_the_references_sharded_step(runs, name):
    """The MoE (drops at capacity factor 1.1, aux) and MLA + MoE (aux,
    MTP) partitioned train steps from the reference's initial parameters
    against the reference's jitted sharded step on (2, 2): losses within
    1e-4, parameters within 5e-4."""
    _held_against_reference_train(runs, name)


@pytest.mark.parametrize("name", MOE_REFERENCE_CASES)
def test_moe_partitioned_decode_equals_the_references_sharded_decode(runs, name):
    _held_against_reference_decode(runs, name)


@pytest.mark.parametrize("name", ["moe_2x2", "moe_1x4", "mla_moe_2x2"])
def test_partitioned_prefill_counts_each_assignment_once(runs, name):
    """``drop_counts`` over the partitioned prefill: each rank counts its
    data shard's assignments once (whichever ``model`` rank runs their
    expert), so one ``model`` column's ranks add up to the one device's
    routed and dropped counts (moe_2x2 drops at capacity factor 1.1)."""
    cfg = ranks.partition_config(name)
    data, model = ranks.PARTITION_CASES[name][2]
    prompt = {"tokens": ranks.partition_batch(cfg)["tokens"][:, :ranks.PREFILL_LEN]}
    reset_drop_counts()
    with set_backend(device="cpu"):
        prefill(ranks.initial_state(cfg).params, cfg, prompt)
    want = drop_counts()
    got = [torch.load(runs / f"partition_rank{r}.pt")["prefill"][name]["drops"]
           for r in range(4)]
    for m in range(model):
        column = [got[d * model + m] for d in range(data)]
        assert {k: sum(c[k] for c in column) for k in want} == want
    if name == "moe_2x2":
        assert 0 < want["dropped"] < want["routed"]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_run_partitioned_moe_cell_against_gathered_and_a_hand_count(arch, kind):
    """A small cell of each MoE family at full width, 2 layers (+ the MTP
    block), 4 rows x 64 positions, in a fake (2, 2) world: the partitioned
    step's peak below the gathered step's by at least the gathered
    parameters' bytes, its collective calls the hand count
    (``tests/torch_dryrun_cases.py``), its FLOPs well under the gathered
    step's."""
    cfg = get_config(arch).scaled(n_layers=2)
    shape = ShapeSpec(f"small_{kind}", kind, 64, 4)
    opt = AdamWConfig()
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        sh = dryrun.shardings_for(mesh, cfg, shape, opt)
        fn, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, part = dryrun.count_step(fn, args)
        gathered = (_sharded_train_step(cfg, opt, 1, True, mesh) if kind == "train"
                    else specs._gathered_step(cfg, "decode", mesh))
        _, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, full = dryrun.count_step(gathered, args)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in specs.param_specs(cfg).parameters())
    assert part.peak_bytes <= full.peak_bytes - param_bytes
    hand = (dry_cases.partitioned_collectives if kind == "train"
            else dry_cases.partitioned_decode_collectives)
    assert part.collective_ops == hand(cfg, (2, 2))
    assert part.flops * 1.5 < full.flops


def test_partitioned_decode_refuses_a_latent_cache_not_split_by_the_sequence():
    """DeepSeek-V3's latent cache of 63 positions on a (2, 2) mesh:
    ``cache_sharding`` puts its latent width on ``model`` (63 does not
    divide by 2), which the partitioned decode does not take; a cache of
    64 positions (the sequence on ``model``, ``Shard(2)``) it takes."""
    cfg = get_config("deepseek-v3-671b").scaled(n_layers=1)
    opt = AdamWConfig()
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        for length in (63, 64):
            shape = ShapeSpec("latent_decode", "decode", length, 4)
            sh = dryrun.shardings_for(mesh, cfg, shape, opt)
            fn, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
            if length == 63:
                assert sh[2]["layers"]["c_kv"] == (None, "data", None, "model")
                with pytest.raises(ValueError, match="sequence on 'model'"):
                    dryrun.count_step(fn, args)
            else:
                assert sh[2]["layers"]["c_kv"] == (None, "data", "model", None)
                dryrun.count_step(fn, args)


# ---- the Mamba2 and Zamba2 families ------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("name", SSM_FACTOR_CASES)
def test_ssm_partition_factor_is_the_references(ssm_runs, name, kind):
    """ranks x per-rank FLOPs / one device's FLOPs of a Mamba2 or Zamba2
    train or decode step: where the SSD heads split (``"heads"``), the
    port's within 10 % of XLA's, or below it; the 6-head
    ``"replicated"`` case's is recorded (every ``model`` rank runs the
    whole mixer, as replicated attention does), and lies below the
    gathered step's 4."""
    port, want = _family_factor(ssm_runs, name, kind)
    cfg = ranks.partition_config(name)
    if ssm_mode(cfg, ranks.PARTITION_CASES[name][2][1]) == "heads":
        assert port <= (1 + FACTOR_TOL) * want, (port, want)
    else:
        assert port < 4, port


@pytest.mark.parametrize("name", SSM_REFERENCE_CASES)
def test_ssm_partitioned_step_equals_the_references_sharded_step(ssm_runs, name):
    """The Mamba2 and Zamba2 partitioned train steps from the reference's
    initial parameters against the reference's jitted sharded step on (2,
    2): losses and parameters within 1e-4."""
    _held_against_reference_train(ssm_runs, name, param_tol=1e-4)


@pytest.mark.parametrize("name", SSM_REFERENCE_CASES)
def test_ssm_partitioned_decode_equals_the_references_sharded_decode(ssm_runs, name):
    """4 partitioned decode steps against the reference's jitted
    ``decode_step`` under ``cache_sharding`` on (2, 2): logits within 1e-4."""
    _held_against_reference_decode(ssm_runs, name)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_run_partitioned_ssm_cell_against_gathered_and_a_hand_count(arch, kind):
    """A small cell of each SSM family at full width (Mamba2-130M 2
    layers; Zamba2-2.7B 4 layers, its shared block every 2, so used
    twice), 4 rows x 64 positions, in a fake (2, 2) world: the partitioned
    step's peak below the gathered step's, its collective calls the hand
    count (``tests/torch_dryrun_cases.py``), its FLOPs under the gathered
    step's."""
    cfg = get_config(arch)
    cfg = cfg.scaled(n_layers=4, hybrid_period=2) if cfg.block_pattern == "zamba2" \
        else cfg.scaled(n_layers=2)
    shape = ShapeSpec(f"small_{kind}", kind, 64, 4)
    opt = AdamWConfig()
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        sh = dryrun.shardings_for(mesh, cfg, shape, opt)
        fn, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, part = dryrun.count_step(fn, args)
        gathered = (_sharded_train_step(cfg, opt, 1, True, mesh) if kind == "train"
                    else specs._gathered_step(cfg, "decode", mesh))
        _, args = specs.step_fn_for(cfg, shape, opt, mesh=mesh, in_shardings=sh)
        _, full = dryrun.count_step(gathered, args)
    print(f"{arch} {kind}: peak {part.peak_bytes} / {full.peak_bytes}, flops {part.flops} / "  # reprolint: disable=R008 the counts PERF.md records (pytest -s)
          f"{full.flops}, collectives {part.collective_ops}")
    assert part.peak_bytes < full.peak_bytes
    hand = (dry_cases.partitioned_collectives if kind == "train"
            else dry_cases.partitioned_decode_collectives)
    assert part.collective_ops == hand(cfg, (2, 2))
    assert part.flops < full.flops
