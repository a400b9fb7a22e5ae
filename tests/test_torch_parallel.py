"""The port's ``parallel/`` slice against the reference, on the CPU.

- Rule parity: ``param_sharding`` / ``serve_param_sharding`` of every
  family's smoke config, ``cache_sharding`` of every family's cache,
  ``batch_sharding`` and ``logical_spec`` equal the reference's
  ``PartitionSpec`` s (less the stacked layer axis; the KV cache's
  (S, heads) axes swapped, as the port lays them out) on the (4, 2),
  (2, 4) and (2, 2, 2) ``pod`` meshes, the reference called with a
  ``jax.sharding.AbstractMesh``.
- ``quantize_int8`` / ``dequantize_int8`` equal the reference's bit for
  bit.
- Multi-rank semantics, the port on 4 ``gloo`` ranks
  (``tests/torch_parallel_ranks.py``) and the reference in a subprocess
  on a 4-device CPU mesh (``XLA_FLAGS``, as ``tests/test_distributed.py``
  runs it), both started together, each with its own timeout:
  the sharded train step on (2, 2) equals the port's own single-device
  step (dense, dense with microbatches, a batch the data axis does not
  divide, MoE under ``gspmd`` with drops and microbatches, MoE under
  ``shard_map`` (no drops; aux coefficient 0, since its aux loss is the
  data shards' estimates averaged) and on (1, 4) with its aux loss, MLA
  + MoE with the MTP head; padding uneven across the data shards); ``moe_apply_sharded`` equals the reference's at capacity
  factor 1.0 and 4.0 (the kept set identical); the compressed gradient
  equals the reference's within one quantisation step and converges;
  a checkpoint saved from (2, 2) restores onto (4, 1) bit for bit;
  ``shard`` lays a ``DTensor`` out on the ambient mesh (with the
  divisibility guard) and leaves a plain tensor alone.
"""

import functools
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import init_decode_cache as ref_init_decode_cache
from repro.models import init_params as ref_init_params
from repro.parallel import batch_sharding as ref_batch_sharding
from repro.parallel import cache_sharding as ref_cache_sharding
from repro.parallel import param_sharding as ref_param_sharding
from repro.parallel import serve_param_sharding as ref_serve_param_sharding
from repro.parallel.constrain import logical_spec as ref_logical_spec
from repro.train.compress import dequantize_int8 as ref_dequantize
from repro.train.compress import quantize_int8 as ref_quantize
from repro_torch.backend import set_backend
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.convert import reference_leaf
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import init_decode_cache, init_params
from repro_torch.models.model import FAMILIES
from repro_torch.parallel import (
    AbstractMesh,
    batch_sharding,
    cache_sharding,
    logical_spec,
    param_sharding,
    serve_param_sharding,
)
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.compress import dequantize_int8, quantize_int8

import torch_parallel_ranks as ranks

MESHES = {"4x2": ((4, 2), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LOSS_TOL, PARAM_TOL = 1e-4, 5e-4  # the reference's test_distributed limits
UPDATE_REL_TOL = 1e-3  # of the largest single-device parameter update
MOE_TOL = 1e-5


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), JaxAbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = ref_smoke_config(arch)
    return jax.eval_shape(lambda k: ref_init_params(k, cfg), jax.random.PRNGKey(0))


def _meta_model(arch):
    cfg = get_smoke_config(arch)
    return FAMILIES[cfg.block_pattern](cfg, device="meta")


def _ref_leaf(tree, key):
    for k in key:
        tree = tree[k]
    return tuple(tree.spec)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


# ---- rule parity -------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rule", ["param", "serve"])
def test_param_rules_equal_the_references(arch, mesh_name, rule):
    mesh, ref_mesh = _meshes(mesh_name)
    port_rule, ref_rule = {"param": (param_sharding, ref_param_sharding),
                           "serve": (serve_param_sharding, ref_serve_param_sharding)}[rule]
    model = _meta_model(arch)
    got = dict(_flat(port_rule(mesh, model)))
    want = ref_rule(ref_mesh, _ref_param_shapes(arch))
    assert len(got) == len(list(model.named_parameters()))
    for name, _ in model.named_parameters():
        key, index = reference_leaf(name)
        spec = _ref_leaf(want, key)
        if index is not None:  # the stacked layer axis has no counterpart
            assert spec[0] is None
            spec = spec[1:]
        assert got[tuple(name.split("."))] == spec, name


def _ref_cache_shapes(arch, batch, seq):
    cfg = ref_smoke_config(arch)
    return jax.eval_shape(
        lambda k: ref_init_decode_cache(ref_init_params(k, cfg), cfg, batch, seq),
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_rules_equal_the_references(arch, mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    cfg = get_smoke_config(arch)
    for batch, seq in ((4, 32), (1, 32), (3, 6)):
        with set_backend(device="cpu"):
            params = init_params(torch.Generator().manual_seed(0), cfg)
            cache = init_decode_cache(params, cfg, batch, seq)
        got = dict(_flat(cache_sharding(mesh, cache)))
        want = dict(jax.tree_util.tree_flatten_with_path(
            ref_cache_sharding(ref_mesh, _ref_cache_shapes(arch, batch, seq)))[0])
        want = {tuple(p.key for p in path): tuple(s.spec) for path, s in want.items()}
        assert set(got) == set(want)
        for path, spec in want.items():
            if path[-1] in ("k", "v"):  # the reference's (L, B, S, H, hd)
                spec = spec[:2] + (spec[3], spec[2]) + spec[4:]
            elif "mamba" in path and len(spec) > 2:  # (n_super, period, B, ...)
                assert spec[:2] == (None, None)
                spec = (None,) + spec[2:]
            if spec == () and len(got[path]) == 0:
                continue
            assert got[path] == spec, (path, batch, seq)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_logical_specs_equal_the_references(mesh_name):
    mesh, ref_mesh = _meshes(mesh_name)
    for b in (1, 2, 3, 4, 8, 16):
        batch = {"tokens": torch.zeros(b, 7, dtype=torch.int32),
                 "patches": torch.zeros(b, 3, 5)}
        got = batch_sharding(mesh, batch)
        want = ref_batch_sharding(ref_mesh, {k: jnp.zeros(v.shape) for k, v in batch.items()})
        assert {k: v for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}
    for tags in (("dp", None, "model"), ("dp",), ("model", "dp"), (None, None),
                 ("pod", "data"), ("expert", "dp")):
        assert logical_spec(mesh, *tags) == tuple(ref_logical_spec(ref_mesh, *tags)), tags


def test_no_process_group_no_mesh_and_no_unsharded_fallback():
    """Without an initialised process group the meshes name the world size
    they need, and the sharded step refuses to be built (it never runs
    unsharded)."""
    with pytest.raises(RuntimeError, match="world size 256"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="world size 512"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="world size 4"):
        make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="never runs unsharded"):
        make_train_step(get_smoke_config("qwen1.5-4b"), AdamWConfig(),
                        mesh=AbstractMesh((2, 2), ("data", "model")))


# ---- int8 quantisation -------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "tiny", "zeros", "ties", "wide"])
def test_quantize_int8_equals_the_references_bit_for_bit(case):
    rng = np.random.default_rng(11)
    x = {"normal": rng.normal(size=(33, 17)),
         "tiny": rng.normal(size=(64,)) * 1e-20,
         "zeros": np.zeros((5, 5)),
         "ties": (np.arange(-254, 255) / 2.0) / 127.0 * 3.0,
         "wide": rng.standard_cauchy(size=(4096,))}[case].astype(np.float32)
    q, scale = quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.numpy().tobytes() == np.asarray(rscale).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(),
                                  np.asarray(ref_dequantize(rq, rscale)))


# ---- multi-rank: the port on gloo ranks, the reference on a 4-device mesh ----

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np, dataclasses, sys
from repro.configs import get_smoke_config
from repro.models.moe_sharded import moe_apply_sharded
from repro.models.ffn import _positions_in_expert
from repro.parallel import compat
from repro.train.compress import init_error_state, make_compressed_grad_fn

out = sys.argv[1]
a = dict(np.load(out + "/moe_inputs.npz"))
mesh = jax.make_mesh((2, 2), ("data", "model"))
res = {}
for name, cf in (("cf1", 1.0), ("cf4", 4.0)):
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="shard_map", capacity_factor=cf))
    p = {"router": {"w": jnp.asarray(a["router"])},
         "experts": {k: jnp.asarray(a[k]) for k in ("wi_gate", "wi_up", "wo")}}
    x = jnp.asarray(a["x"])
    with compat.set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe_apply_sharded(p, cfg, x, mesh))(p, x)
    res[name + "_y"], res[name + "_aux"] = np.asarray(y), np.asarray(aux)
    # the kept set of each (data, model) rank, by the reference's routing
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    b_loc = x.shape[0] // 2
    for dd in range(2):
        xl = x[dd * b_loc:(dd + 1) * b_loc].reshape(-1, x.shape[-1])
        n = xl.shape[0]
        cap = max(1, int(n * k / e * cf))
        probs = jax.nn.softmax(xl.astype(jnp.float32) @ p["router"]["w"], axis=-1)
        _, top_i = jax.lax.top_k(probs, k)
        flat_e = top_i.reshape(n * k)
        pos = _positions_in_expert(flat_e, e)
        for mm in range(2):
            local = flat_e - mm * (e // 2)
            mine = (local >= 0) & (local < e // 2)
            res[f"{name}_keep_{dd}{mm}"] = np.asarray(mine & (pos < cap))

c = dict(np.load(out + "/compress_inputs.npz"))
xs, ys = jnp.asarray(c["xs"]), jnp.asarray(c["ys"])
cmesh = jax.make_mesh((4,), ("data",))

def grad_fn(params, batch):
    x, y = batch
    return jax.grad(lambda q: jnp.mean((x @ q - y) ** 2))(params)

w = jnp.zeros((16,))
fn = jax.jit(make_compressed_grad_fn(grad_fn, cmesh))
err = init_error_state(w, 4)
g, err = fn(w, (xs, ys), err)
res["compress_g"], res["compress_err"] = np.asarray(g), np.asarray(err)
res["compress_exact"] = np.asarray(grad_fn(w, (xs, ys)))

@jax.jit
def steps(w, err):
    def body(carry, _):
        w, err = carry
        g, err = fn(w, (xs, ys), err)
        return (w - 0.1 * g, err), None
    (w, err), _ = jax.lax.scan(body, (w, err), None, length=300)
    return w

res["compress_w"] = np.asarray(steps(w, err))
np.savez(out + "/reference.npz", **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs: the port's 4 gloo ranks and the reference's
    4-device subprocess, started together."""
    out = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(21)
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    np.savez(out / "moe_inputs.npz",
             x=rng.normal(size=(4, 8, d)).astype(np.float32),
             router=(rng.normal(size=(d, e)) * d ** -0.5).astype(np.float32),
             wi_gate=(rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
             wi_up=(rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
             wo=(rng.normal(size=(e, f, d)) * f ** -0.5).astype(np.float32))
    xs = rng.normal(size=(64, 16)).astype(np.float32)
    np.savez(out / "compress_inputs.npz", xs=xs, ys=xs @ np.arange(16, dtype=np.float32))
    reference = subprocess.Popen(
        [sys.executable, "-c",
         "import os\n"
         'os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"\n'
         + textwrap.dedent(REFERENCE), str(out)],
        env=ranks.subprocess_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks.wait_all([*ranks.start_ranks("parallel", 4, out), reference])
    return out


def _single_device_runs(name):
    """The port's own single-device step on the same case."""
    cfg = ranks.step_config(name)
    with set_backend(device="cpu"):
        state = ranks.initial_state(cfg)
        init = {n: p.detach().clone() for n, p in state.params.named_parameters()}
        step = make_train_step(cfg, AdamWConfig(**ranks.OPT),
                               microbatches=ranks.STEP_CASES[name][4])
        st, metrics = state.as_dict(), []
        batch = ranks.step_batch(name, cfg.vocab)
        for _ in range(ranks.STEPS):
            st, m = step(st, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return init, {n: p.detach() for n, p in st["params"].named_parameters()}, st["opt"], metrics


@pytest.mark.parametrize("name", list(ranks.STEP_CASES))
def test_sharded_step_equals_the_single_device_step(runs, name):
    got = torch.load(runs / "train_step.pt")[name]
    init, want, opt, want_metrics = _single_device_runs(name)
    for g, w in zip(got["metrics"], want_metrics):
        assert abs(g["loss"] - w["loss"]) < LOSS_TOL
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"]
        assert set(g) == set(w)
    flat = {".".join(p): t for p, t in _flat(got["params"])}
    moved = max(float((want[n] - init[n]).abs().max()) for n in want)
    assert moved > 1e-3  # the steps moved the parameters (updates linear in the gradient)
    for n, w in want.items():
        err = float((flat[n] - w).abs().max())
        assert err < PARAM_TOL and err <= UPDATE_REL_TOL * moved, (n, err, moved)
    m = {".".join(p): t for p, t in _flat(got["m"])}
    for n, w in {".".join(p): t for p, t in _flat(opt["m"])}.items():
        assert float((m[n] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-6), n


@pytest.mark.parametrize("case", list(ranks.MOE_CASES))
def test_moe_apply_sharded_equals_the_references(runs, case):
    ref = dict(np.load(runs / "reference.npz"))
    x = np.load(runs / "moe_inputs.npz")["x"]
    b_loc = x.shape[0] // 2
    kept = 0
    for rank in range(4):
        dd, mm = divmod(rank, 2)  # the (data, model) mesh is rank-major
        got = torch.load(runs / f"moe_rank{rank}.pt")[case]
        np.testing.assert_array_equal(got["keep"].numpy(), ref[f"{case}_keep_{dd}{mm}"])
        np.testing.assert_allclose(got["y"].numpy(), ref[f"{case}_y"][dd * b_loc:(dd + 1) * b_loc],
                                   rtol=0, atol=MOE_TOL)
        assert abs(float(got["aux"]) - float(ref[f"{case}_aux"])) <= MOE_TOL
        kept += int(got["keep"].sum())
    n_assign = x.shape[0] * x.shape[1] * get_smoke_config("qwen3-moe-235b-a22b").moe.top_k
    if case == "cf1":
        assert kept < n_assign  # capacity factor 1.0 drops some assignments
    else:
        assert kept == n_assign


def test_compressed_grads_equal_the_references_within_one_step(runs):
    ref = dict(np.load(runs / "reference.npz"))
    c = np.load(runs / "compress_inputs.npz")
    xs, ys = c["xs"].astype(np.float64), c["ys"].astype(np.float64)
    # the first step's common scale: the largest |local gradient| / 127 (at
    # w = 0 a shard's gradient is -2/16 x^T y)
    local = [-2 / 16 * xs[r * 16:(r + 1) * 16].T @ ys[r * 16:(r + 1) * 16] for r in range(4)]
    scale = max(np.abs(g).max() for g in local) / 127
    out = [torch.load(runs / f"compress_rank{r}.pt") for r in range(4)]
    g = out[0]["first"]["g"].numpy()
    for o in out[1:]:
        np.testing.assert_array_equal(o["first"]["g"].numpy(), g)  # the same on every rank
    assert np.abs(g - ref["compress_g"]).max() <= scale / 4 * (1 + 1e-5)
    exact = ref["compress_exact"]
    assert np.abs(g - exact).max() / np.abs(exact).max() < 0.02
    for r, o in enumerate(out):  # each rank's residual: its own, as the reference's device's
        assert o["first"]["err"].shape == (1, 16)
        np.testing.assert_allclose(o["first"]["err"].numpy()[0], ref["compress_err"][r],
                                   rtol=0, atol=scale * (1 + 1e-5))


def test_compressed_descent_converges_as_the_references(runs):
    ref = dict(np.load(runs / "reference.npz"))
    for r in range(4):
        w = torch.load(runs / f"compress_rank{r}.pt")["w"].numpy()
        assert np.abs(w - np.arange(16.0)).max() < 0.05
    assert np.abs(ref["compress_w"] - np.arange(16.0)).max() < 0.05


def test_elastic_restore_across_meshes_is_bit_for_bit(runs):
    for r in range(4):
        out = torch.load(runs / f"elastic_rank{r}.pt")
        assert out["leaves"] > 0 and out["identical"] == out["leaves"]


def test_shard_lays_a_dtensor_out_on_the_ambient_mesh(runs):
    for r in range(4):
        checks = torch.load(runs / f"constrain_rank{r}.pt")
        assert all(checks.values()), checks
