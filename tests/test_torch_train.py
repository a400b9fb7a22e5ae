"""The port's training stack against the reference's, on the CPU.

- the loss math (``softmax_xent`` with padding), the schedule,
  ``adamw_update`` with clipping (both moment dtypes) and
  ``global_norm`` against the reference's;
- ``forward_train`` of every ported family's smoke config (dense, vlm
  with its patch prefix, moe, mla_moe with the MTP head, mamba2,
  zamba2, encdec with its frames): logits, the MoE aux loss and the MTP
  logits within 1e-4, with the weights carried over by
  ``convert.from_reference_params``;
- three ``make_train_step`` steps against the reference's: loss, grad
  norm and every updated parameter (through ``convert.reference_names``)
  within 1e-4; two microbatches against the full batch; the MTP loss for
  DeepSeek; remat on and off equal; a fixed batch memorised;
- each kernel's ``torch.autograd.Function`` (K4, K6, K7): its gradients
  on the CPU (forward: the plain version; backward: the math the card
  runs too) against autograd through the plain version, within 1e-5.

Float32 throughout; the kernels take their plain versions on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init_params
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train.optim import adamw_init as ref_adamw_init
from repro.train.optim import adamw_update as ref_adamw_update
from repro.train.optim import global_norm as ref_global_norm
from repro.train.optim import schedule as ref_schedule
from repro.train.step import softmax_xent as ref_softmax_xent
from repro_torch.backend import set_backend
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference_params, reference_names
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.models import forward_train
from repro_torch.train import AdamWConfig, TrainState, adamw_init, make_train_step
from repro_torch.train.optim import adamw_update, global_norm, param_tree, schedule
from repro_torch.train.step import softmax_xent

ATOL = 1e-4
FAMILIES = {  # one smoke config per ported family
    "dense": "qwen1.5-4b",
    "vlm": "llava-next-mistral-7b",
    "moe": "qwen3-moe-235b-a22b",
    "mla_moe": "deepseek-v3-671b",
    "mamba2": "mamba2-130m",
    "zamba2": "zamba2-2.7b",
    "encdec": "whisper-medium",
}


@pytest.fixture(autouse=True)
def _cpu():
    with set_backend(device="cpu"):
        yield


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _setup(arch: str, seed: int):
    ref_cfg = ref_smoke_config(arch)
    tree = ref_init_params(jax.random.PRNGKey(seed), ref_cfg)
    cfg = get_smoke_config(arch)
    return ref_cfg, tree, cfg, from_reference_params(jax.tree.map(np.asarray, tree), cfg)


def _batches(cfg, seed: int, b: int = 2, s: int = 16):
    """The same (reference, port) batch: tokens, targets and, for vlm, the
    patch prefix (for encdec, the frames), drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    ref = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    port = {"tokens": _t(toks[:, :-1]), "targets": _t(toks[:, 1:])}
    if cfg.block_pattern == "vlm":
        patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        ref["patches"], port["patches"] = jnp.asarray(patches), _t(patches)
    if cfg.block_pattern == "encdec":
        frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        ref["frames"], port["frames"] = jnp.asarray(frames), _t(frames)
    return ref, port


def _ref_leaf(tree, key, index):
    leaf = tree
    for k in key:
        leaf = leaf[k]
    leaf = np.asarray(leaf)
    return leaf if index is None else leaf[index]


# ---- loss, schedule, optimizer ------------------------------------------------


@pytest.mark.parametrize("pad", [0, 3])
def test_softmax_xent_matches_the_reference(pad):
    rng = np.random.default_rng(pad)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    targets[0, :pad] = -1
    got = softmax_xent(_t(logits), _t(targets))
    want = ref_softmax_xent(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_xent_ignores_padding():
    got = softmax_xent(torch.zeros(1, 4, 7), torch.tensor([[1, 2, -1, -1]]))
    np.testing.assert_allclose(float(got), np.log(7.0), rtol=1e-6)
    assert float(softmax_xent(torch.zeros(1, 2, 7), torch.full((1, 2), -1))) == 0.0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_matches_the_reference(step):
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    want = ref_schedule(RefAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100),
                        jnp.int32(step))
    np.testing.assert_allclose(float(schedule(cfg, step)), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 1e6])  # 1e6: the clip binds
def test_adamw_update_matches_the_reference(moment_dtype, scale):
    """Three updates of a two-leaf tree (weight decay on), the gradients
    scaled past ``clip_norm`` in one case: parameters, moments and the
    metrics equal the reference's."""
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
    cfg, ref_cfg = AdamWConfig(**kw), RefAdamWConfig(**kw)
    rng = np.random.default_rng(int(scale))
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "n": {"b": rng.standard_normal(5).astype(np.float32)}}
    ref_params = jax.tree.map(jnp.asarray, params)
    port_params = {"w": _t(params["w"]), "n": {"b": _t(params["n"]["b"])}}
    ref_state, state = ref_adamw_init(ref_cfg, ref_params), adamw_init(cfg, port_params)
    for i in range(3):
        g = {"w": rng.standard_normal((4, 3)).astype(np.float32) * scale,
             "n": {"b": rng.standard_normal(5).astype(np.float32) * scale}}
        ref_params, ref_state, ref_m = ref_adamw_update(
            ref_cfg, jax.tree.map(jnp.asarray, g), ref_state, ref_params)
        port_params, state, m = adamw_update(
            cfg, {"w": _t(g["w"]), "n": {"b": _t(g["n"]["b"])}}, state, port_params)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)
        for key in ("w", "n"):
            got = port_params[key] if key == "w" else port_params["n"]["b"]
            want = ref_params[key] if key == "w" else ref_params["n"]["b"]
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        got_m = state["m"]["w"].float().numpy()
        np.testing.assert_allclose(got_m, np.asarray(ref_state["m"]["w"], np.float32),
                                   rtol=1e-2 if moment_dtype == "bfloat16" else 1e-5)
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
    if scale > 1:
        assert float(m["grad_norm"]) > 1e6  # reported before the clip
        assert np.isfinite(port_params["w"].numpy()).all()


def test_global_norm_matches_the_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    got = global_norm({"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}})
    np.testing.assert_allclose(float(got), float(ref_global_norm(tree)), rtol=1e-6)


def test_adamw_moves_toward_minimum():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100,
                      moment_dtype="float32")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(cfg, params)
    for _ in range(100):
        params, state, _ = adamw_update(cfg, {"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.5


# ---- forward_train -----------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_train_matches_the_reference(family):
    """Logits (B, S, V) (vlm: the token suffix), aux and MTP logits."""
    arch = FAMILIES[family]
    ref_cfg, tree, cfg, params = _setup(arch, seed=0)
    ref_batch, batch = _batches(cfg, seed=1)
    want, want_aux, want_mtp = ref_forward_train(tree, ref_cfg, ref_batch)
    rnk.reset_counts()
    got, aux, mtp = forward_train(params, cfg, batch)
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)
    if cfg.moe.n_experts:
        assert float(aux) > 0  # the load-balance loss, summed over layers
    assert (mtp is None) == (want_mtp is None) == (family != "mla_moe")
    if mtp is not None:
        np.testing.assert_allclose(mtp.detach().numpy(), np.asarray(want_mtp), atol=ATOL)
    assert rnk.COUNTS["rmsnorm"] == 0 and rnk.COUNTS["plain"] > 0  # K4's entry, on the CPU


# ---- the train step --------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "llava-next-mistral-7b", "zamba2-2.7b",
                                  "deepseek-v3-671b", "whisper-medium"])
def test_train_steps_match_the_reference(arch):
    """Three steps on one batch: loss, grad norm and every parameter after
    each update, leaf by leaf through the name map."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=20, moment_dtype="float32")
    ref_cfg, tree, cfg, params = _setup(arch, seed=2)
    ref_batch, batch = _batches(cfg, seed=3)
    ref_state = {"params": tree, "opt": ref_adamw_init(RefAdamWConfig(**kw), tree)}
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefAdamWConfig(**kw)))
    state = TrainState(params, adamw_init(AdamWConfig(**kw), params)).as_dict()
    step = make_train_step(cfg, AdamWConfig(**kw))
    names = reference_names(params)
    for _ in range(3):
        ref_state, ref_m = ref_step(ref_state, ref_batch)
        state, m = step(state, batch)
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-4,
                                       atol=ATOL, err_msg=key)
        for name, p in state["params"].named_parameters():
            want = _ref_leaf(ref_state["params"], *names[name])
            np.testing.assert_allclose(p.detach().numpy(), want, atol=ATOL, err_msg=name)
    if cfg.mtp_depth:
        np.testing.assert_allclose(float(m["mtp_ce"]), float(ref_m["mtp_ce"]), rtol=1e-4)


def test_microbatched_grads_match_full_batch():
    cfg_opt = AdamWConfig(moment_dtype="float32")
    _, tree, cfg, params = _setup("qwen1.5-4b", seed=1)
    _, batch = _batches(cfg, seed=1, b=4)
    twin = from_reference_params(jax.tree.map(np.asarray, tree), cfg)
    s1, m1 = make_train_step(cfg, cfg_opt)({"params": params, "opt": adamw_init(cfg_opt, params)},
                                           batch)
    s2, m2 = make_train_step(cfg, cfg_opt, microbatches=2)(
        {"params": twin, "opt": adamw_init(cfg_opt, twin)}, batch)
    err = max(float((a - b).detach().abs().max()) for a, b in zip(s1["params"].parameters(),
                                                          s2["params"].parameters()))
    assert err < 5e-5, err
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)


def test_microbatches_split_the_frames_too():
    """Whisper's batch split in two microbatches (tokens, targets and
    frames alike) gives the full batch's update."""
    cfg_opt = AdamWConfig(moment_dtype="float32")
    _, tree, cfg, params = _setup("whisper-medium", seed=1)
    _, batch = _batches(cfg, seed=1, b=4)
    twin = from_reference_params(jax.tree.map(np.asarray, tree), cfg)
    s1, m1 = make_train_step(cfg, cfg_opt)({"params": params, "opt": adamw_init(cfg_opt, params)},
                                           batch)
    s2, m2 = make_train_step(cfg, cfg_opt, microbatches=2)(
        {"params": twin, "opt": adamw_init(cfg_opt, twin)}, batch)
    err = max(float((a - b).detach().abs().max()) for a, b in zip(s1["params"].parameters(),
                                                          s2["params"].parameters()))
    assert err < 5e-5, err
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)


def test_mtp_loss_present_for_deepseek():
    cfg_opt = AdamWConfig(moment_dtype="float32")
    _, _, cfg, params = _setup("deepseek-v3-671b", seed=2)
    _, batch = _batches(cfg, seed=2)
    _, metrics = make_train_step(cfg, cfg_opt)(
        {"params": params, "opt": adamw_init(cfg_opt, params)}, batch)
    assert "mtp_ce" in metrics and np.isfinite(float(metrics["mtp_ce"]))
    grads = [p for name, p in params.named_parameters() if name.startswith("mtp.")]
    assert grads  # the head's weights moved with the rest


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-130m"])
def test_remat_on_and_off_give_equal_results(arch):
    _, tree, cfg, params = _setup(arch, seed=4)
    _, batch = _batches(cfg, seed=4)
    grads = {}
    for remat in (False, True):
        for p in params.parameters():
            p.requires_grad_(True)
            p.grad = None
        logits, _, _ = forward_train(params, cfg, batch, remat=remat)
        softmax_xent(logits, batch["targets"]).backward()
        grads[remat] = [p.grad.clone() for p in params.parameters()]
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_encdec_remat_on_and_off_give_equal_results():
    """Whisper's decoder layers recomputed or not (its encoder layers are
    recomputed either way, as the reference's): the same gradients."""
    _, _, cfg, params = _setup("whisper-medium", seed=4)
    _, batch = _batches(cfg, seed=4)
    grads = {}
    for remat in (False, True):
        for p in params.parameters():
            p.requires_grad_(True)
            p.grad = None
        logits, _, _ = forward_train(params, cfg, batch, remat=remat)
        softmax_xent(logits, batch["targets"]).backward()
        grads[remat] = [p.grad.clone() for p in params.parameters()]
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
    assert all(float(g.abs().sum()) > 0 for g in grads[True])  # every leaf, encoder too


def test_train_step_memorizes_fixed_batch():
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50, moment_dtype="float32")
    _, _, cfg, params = _setup("qwen1.5-4b", seed=0)
    _, batch = _batches(cfg, seed=0, b=4, s=32)
    state = TrainState(params, adamw_init(opt, params)).as_dict()
    step = make_train_step(cfg, opt)
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_state_tree_names_mirror_the_parameters():
    opt = AdamWConfig()
    _, _, cfg, params = _setup("qwen1.5-4b", seed=0)
    state = TrainState(params, adamw_init(opt, params))
    tree = state.tree()
    assert tree["params"]["layers"]["1"]["attn"]["wq"]["w"] is params.layers[1].attn.wq.w
    assert tree["opt"]["m"]["layers"]["1"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert set(tree["opt"]["v"]) == set(param_tree(params)) == {"embed", "final_norm", "layers"}


# ---- the kernels' autograd Functions ----------------------------------------------


def _grads(fn, inputs, seed):
    """d(sum(out * w))/d(inputs) for a fixed random weight w per output."""
    rng = np.random.default_rng(seed)
    xs = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * _t(rng.standard_normal(o.shape).astype(np.float32))).sum() for o in outs)
    return torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 5, 4, 16), (1, 1000)])
def test_rmsnorm_function_gradient_equals_autograd_of_the_plain_version(shape):
    rng = np.random.default_rng(len(shape))
    x = _t(rng.standard_normal(shape).astype(np.float32))
    g = _t(rng.standard_normal(shape[-1:]).astype(np.float32))
    got = _grads(lambda a, b: rnk.rmsnorm_fn(a, b, 1e-5), (x, g), 0)
    want = _grads(lambda a, b: rnk.rmsnorm_plain(a, b, 1e-5), (x, g), 0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,hkv,s,t,hd,causal,chunk_elems", [
    (2, 4, 2, 33, 33, 16, True, None),
    (1, 6, 3, 20, 45, 8, False, None),
    (2, 4, 1, 40, 17, 12, True, 2 * 4 * 17 * 7),  # query rows in chunks of 7
    (1, 2, 2, 64, 64, 32, True, 1),  # one row a chunk
    (2, 4, 4, 1, 37, 16, False, None),  # cross-attention at decode: dK / dV of T != S
    (1, 4, 4, 5, 300, 16, False, 4 * 300 * 2),  # a cross prefill, rows in chunks of 2
])
def test_flash_attention_function_gradient_equals_autograd_of_the_plain_version(
        b, h, hkv, s, t, hd, causal, chunk_elems, monkeypatch):
    if chunk_elems is not None:
        monkeypatch.setattr(fak, "BACKWARD_CHUNK_ELEMS", chunk_elems)
    rng = np.random.default_rng(s + t)
    q = _t(rng.standard_normal((b, h, s, hd)).astype(np.float32))
    k = _t(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    v = _t(rng.standard_normal((b, hkv, t, hd)).astype(np.float32))
    fak.reset_counts()
    got = _grads(lambda *a: fak.flash_attention_fn(*a, causal=causal), (q, k, v), 1)
    assert fak.COUNTS["plain"] == 1  # the forward; the backward is its own math
    want = _grads(lambda *a: fak.flash_attention_plain(*a, causal=causal), (q, k, v), 1)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,chunk", [(64, 32), (50, 16), (7, 256)])
def test_ssd_scan_function_gradient_equals_autograd_of_the_plain_version(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 4, 5
    x = _t(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = _t(rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32))
    a = _t(-rng.uniform(0.5, 2.0, h).astype(np.float32))
    bm = _t(rng.standard_normal((b, s, n)).astype(np.float32))
    cm = _t(rng.standard_normal((b, s, n)).astype(np.float32))
    ssk.reset_counts()
    got = _grads(lambda *t: ssk.ssd_scan_fn(*t, chunk=chunk), (x, dt, a, bm, cm), 2)
    assert ssk.COUNTS["plain"] == 1
    want = _grads(lambda *t: ssk.ssd_scan_plain(*t, chunk), (x, dt, a, bm, cm), 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


def test_functions_are_skipped_where_autograd_does_not_record():
    """Under no_grad the entries call the wrappers themselves: serving
    launches what it launched before."""
    x, g = torch.ones(2, 8), torch.ones(8)
    with torch.no_grad():
        y = rnk.rmsnorm_fn(x.requires_grad_(True), g)
    assert y.grad_fn is None
    y = rnk.rmsnorm_fn(torch.ones(2, 8, requires_grad=True), g)
    assert type(y.grad_fn).__name__ == "RMSNormFunctionBackward"
