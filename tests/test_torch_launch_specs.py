"""The port's ``configs/shapes.py`` and ``launch/specs.py`` against the
reference's, at full size, on the CPU.

- ``SHAPES``, ``get_shape`` and ``applicable`` equal the reference's for
  every arch and shape, the skip reason letter for letter.
- ``input_specs``, ``param_specs``, ``state_specs`` and ``cache_specs``
  (``meta`` tensors, nothing allocated) equal the reference's
  ``jax.eval_shape`` trees leaf by leaf in shape and dtype, for all ten
  archs at their published sizes: a parameter maps through
  ``repro_torch.convert.reference_leaf``, the port's per-layer leaves
  stacked against the reference's layer axis; the KV cache's (S, heads)
  axes swapped and Zamba2's Mamba2 state flat over its layers, as the
  port lays them out.
- The rank blocks ``step_fn_for`` places on both production meshes
  (rank 0 of a fake world of 256 / 512 ranks, in a subprocess each,
  started with the module's first test: ``tests/torch_dryrun_cases.py``)
  equal the reference's
  ``NamedSharding(...).shard_shape`` of its ``param_sharding``,
  ``batch_sharding`` and ``cache_sharding`` on a jax ``AbstractMesh`` of
  the same axes, leaf by leaf, at full size.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding

from repro.configs import get_config as ref_get_config
from repro.configs import shapes as ref_shapes
from repro.launch import specs as ref_specs
from repro.parallel import batch_sharding as ref_batch_sharding
from repro.parallel import cache_sharding as ref_cache_sharding
from repro.parallel import param_sharding as ref_param_sharding
from repro.train import AdamWConfig as RefAdamWConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes
from repro_torch.convert import reference_leaf
from repro_torch.launch import specs
from repro_torch.parallel import AbstractMesh
from repro_torch.train import AdamWConfig

import torch_dryrun_cases as cases

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DECODE_SHAPES = ("decode_32k", "long_500k")


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).name


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _ref_flat(tree) -> dict:
    return {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# the reference's eval_shape trees, traced once a module
@functools.lru_cache(maxsize=None)
def _ref_param_tree(arch):
    return ref_specs.param_specs(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_cache_tree(arch, shape_name):
    shape = ref_shapes.get_shape(shape_name)
    return ref_specs.cache_specs(ref_get_config(arch), shape.global_batch, shape.seq_len)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return _ref_flat(_ref_param_tree(arch))


def _ref_cache(arch, shape_name):
    return _ref_flat(_ref_cache_tree(arch, shape_name))


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Rank 0's blocks in the fake worlds (``tests/torch_dryrun_cases.py
    blocks-single`` and ``blocks-multi``), each in a subprocess started
    with the module's first test, so that they run beside the tests of
    the specs."""
    tasks = [cases.Started(tmp_path_factory.mktemp(task), task, timeout=600)
             for task in ("blocks-single", "blocks-multi")]
    yield tasks
    for task in tasks:
        task.stop()


@pytest.fixture(scope="module")
def blocks(started):
    return {k: v for task in started for out in task.result().values() for k, v in out.items()}


def _decode_shapes(arch):
    cfg = get_config(arch)
    return [s for s in DECODE_SHAPES if shapes.applicable(cfg, shapes.get_shape(s))[0]]


def _params_against_reference(named: dict, ref: dict, ref_dtype=None) -> None:
    """Every port leaf (name -> shape, dtype) lands on a reference leaf;
    the per-layer leaves of a stacked reference leaf cover its layer axis
    once each, every one of its per-layer shape."""
    layers: dict = {}
    for name, (shape, dtype) in named.items():
        key, index = reference_leaf(name)
        assert key in ref, name
        want = ref[key]
        assert dtype == (ref_dtype or _dtype(want)), name
        if index is None:
            assert tuple(shape) == tuple(want.shape), name
        else:
            assert tuple(shape) == tuple(want.shape[1:]), name
            layers.setdefault(key, []).append(index)
    for key, want in ref.items():
        if key in layers:
            assert sorted(layers[key]) == list(range(want.shape[0])), key
        else:
            assert any(reference_leaf(n)[0] == key for n in named), key


def _cache_against_reference(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for path, want in ref.items():
        shape = tuple(want.shape)
        if path[-1] in ("k", "v"):  # the reference's (L, B, S, H, hd)
            shape = shape[:2] + (shape[3], shape[2]) + shape[4:]
        elif "mamba" in path:  # the reference's (n_super, period, B, ...)
            shape = (shape[0] * shape[1],) + shape[2:]
        assert tuple(got[path][0]) == shape, path
        assert got[path][1] == _dtype(want), path


# ---- configs/shapes.py -------------------------------------------------------


def test_shapes_equal_the_references():
    assert [dataclasses.astuple(s) for s in shapes.SHAPES] == \
        [dataclasses.astuple(s) for s in ref_shapes.SHAPES]
    for s in ref_shapes.SHAPES:
        assert dataclasses.astuple(shapes.get_shape(s.name)) == dataclasses.astuple(s)
    with pytest.raises(KeyError):
        shapes.get_shape("train_8k")
    with pytest.raises(KeyError):
        ref_shapes.get_shape("train_8k")


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_equals_the_references_letter_for_letter(arch):
    for s in ref_shapes.SHAPES:
        got = shapes.applicable(get_config(arch), shapes.get_shape(s.name))
        assert got == ref_shapes.applicable(ref_get_config(arch), s)
    assert shapes.applicable(get_config(arch), shapes.get_shape("long_500k"))[0] == (
        get_config(arch).block_pattern in ("mamba2", "zamba2"))


# ---- launch/specs.py at full size ------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references(arch):
    for s in ref_shapes.SHAPES:
        got = specs.input_specs(get_config(arch), shapes.get_shape(s.name))
        want = ref_specs.input_specs(ref_get_config(arch), s)
        assert set(got) == set(want), s.name
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (s.name, k)
            assert _dtype(v) == _dtype(want[k]), (s.name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch):
    model = specs.param_specs(get_config(arch))
    named = {n: (tuple(p.shape), _dtype(p)) for n, p in model.named_parameters()}
    assert all(p.device.type == "meta" for p in model.parameters())
    _params_against_reference(named, _ref_params(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_the_references(arch):
    got = specs.state_specs(get_config(arch), AdamWConfig())
    want = ref_specs.state_specs(ref_get_config(arch), RefAdamWConfig())
    named = {n: (tuple(p.shape), _dtype(p)) for n, p in got["params"].named_parameters()}
    _params_against_reference(named, _ref_params(arch))
    for moment in ("m", "v"):
        leaves = {".".join(path): (tuple(t.shape), _dtype(t))
                  for path, t in _flat(got["opt"][moment])}
        assert set(leaves) == set(named)
        assert all(t.device.type == "meta" for _, t in _flat(got["opt"][moment]))
        _params_against_reference(leaves, _ref_flat(want["opt"][moment]),
                                  ref_dtype=AdamWConfig().moment_dtype)
    step = got["opt"]["step"]
    assert tuple(step.shape) == tuple(want["opt"]["step"].shape) == ()
    assert _dtype(step) == _dtype(want["opt"]["step"]) == "int32"


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch):
    cfg = get_config(arch)
    for shape_name in _decode_shapes(arch):
        shape = shapes.get_shape(shape_name)
        got = specs.cache_specs(cfg, shape.global_batch, shape.seq_len)
        flat = {path: (tuple(t.shape), _dtype(t)) for path, t in _flat(got)}
        assert all(t.device.type == "meta" for _, t in _flat(got))
        _cache_against_reference(flat, _ref_cache(arch, shape_name))


def test_step_fn_for_builds_every_cell_on_meta_without_a_mesh():
    """Each kind's (fn, args): the reference's arguments, on ``meta``."""
    cfg = get_config("qwen1.5-4b")
    fn, args = specs.step_fn_for(cfg, shapes.get_shape("train_4k"), AdamWConfig())
    assert set(args[0]) == {"params", "opt"} and set(args[1]) == {"tokens", "targets"}
    fn, args = specs.step_fn_for(cfg, shapes.get_shape("prefill_32k"), AdamWConfig())
    assert set(args[1]) == {"tokens"} and args[1]["tokens"].device.type == "meta"
    fn, args = specs.step_fn_for(cfg, shapes.get_shape("decode_32k"), AdamWConfig())
    assert tuple(args[1].shape) == (128, 1)
    assert tuple(args[2]["layers"]["k"].shape) == (40, 128, 20, 32768, 128)
    with pytest.raises(ValueError):
        specs.step_fn_for(cfg, shapes.ShapeSpec("x", "serve", 8, 1), AdamWConfig())
    with pytest.raises(ValueError, match="in_shardings"):
        specs.step_fn_for(cfg, shapes.get_shape("decode_32k"), AdamWConfig(),
                          mesh=AbstractMesh((16, 16), ("data", "model")))


# ---- rank blocks on the production meshes ------------------------------------------


def _jax_mesh(mesh_name):
    shape, names = MESHES[mesh_name]
    return JaxAbstractMesh(shape, names)


def _shard_shapes(tree, specs_tree, mesh) -> dict:
    spec_of = _ref_flat(specs_tree)
    return {path: NamedSharding(mesh, spec_of[path].spec).shard_shape(tuple(leaf.shape))
            for path, leaf in _ref_flat(tree).items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_blocks_equal_the_references_shard_shapes(blocks, arch, mesh_name):
    mesh = _jax_mesh(mesh_name)
    ref_tree = _ref_param_tree(arch)
    want = _shard_shapes(ref_tree, ref_param_sharding(mesh, ref_tree), mesh)
    got = blocks[f"{mesh_name}/{arch}"]["params"]
    assert len(got) == len(list(specs.param_specs(get_config(arch)).parameters()))
    for path, shape in got.items():
        key, index = reference_leaf(path.replace("/", "."))
        ref_shape = want[key]
        if index is not None:  # the stacked layer axis is never sharded
            assert ref_shape[0] == _ref_params(arch)[key].shape[0]
            ref_shape = ref_shape[1:]
        assert tuple(shape) == tuple(ref_shape), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_blocks_equal_the_references_shard_shapes(blocks, arch, mesh_name):
    mesh = _jax_mesh(mesh_name)
    cfg = ref_get_config(arch)
    row = blocks[f"{mesh_name}/{arch}"]
    for s in ref_shapes.SHAPES:
        if s.kind == "train" or not ref_shapes.applicable(cfg, s)[0]:
            continue
        batch = ref_specs.input_specs(cfg, s)
        want = _shard_shapes(batch, ref_batch_sharding(mesh, batch), mesh)
        got = row[f"batch/{s.name}"]
        assert set(got) == {"/".join(k) for k in want}, s.name
        for path, shape in want.items():
            assert tuple(got["/".join(path)]) == tuple(shape), (s.name, path)
        if s.kind != "decode":
            continue
        cache = _ref_cache_tree(arch, s.name)
        want = _shard_shapes(cache, ref_cache_sharding(mesh, cache), mesh)
        got = {tuple(k.split("/")): (v, None) for k, v in row[f"cache/{s.name}"].items()}
        assert set(got) == set(want), s.name
        for path, shape in want.items():
            shape = tuple(shape)
            if path[-1] in ("k", "v"):
                shape = shape[:2] + (shape[3], shape[2]) + shape[4:]
            elif "mamba" in path:
                assert shape[:2] == tuple(_ref_flat(cache)[path].shape[:2])
                shape = (shape[0] * shape[1],) + shape[2:]
            assert tuple(got[path][0]) == shape, (s.name, path)
