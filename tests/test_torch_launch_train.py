"""The port's train driver (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), on the CPU.

Both drivers run ``--smoke --steps 3`` from the same initial state (the
port's ``train_state_init`` swapped for the reference's ``PRNGKey(0)``
state, carried over by ``from_reference_params``) on the same
locality-aware loader; their final checkpoints agree leaf by leaf within
1e-4 (parameters and both AdamW moments, through
``convert.reference_names``; the step exactly), each read by the other
package's reader.  A second port run resumes from step 3; both drivers
end in ``KeyError: 'frames'`` for Whisper (they feed tokens only); the
port refuses ``--production-mesh`` outside a world of 256 ranks; without
``--ckpt-dir`` each arch checkpoints into its own folder under the
temporary directory.  The ``--production-mesh`` loop (:func:`repro_torch.
launch.train.train` on a mesh) runs on 4 ``gloo`` ranks
(``tests/torch_parallel_ranks.py``): 3 steps sharded on (2, 2), then
resumed onto (4, 1) to step 5, its losses those of the single-device
driver run the same way.
"""

import jax
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import train as ref_launch
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import train_state_init as ref_train_state_init
from repro_torch.backend import set_backend
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_reference_params, reference_names
from repro_torch.launch import train as launch
from repro_torch.train import AdamWConfig, TrainState, adamw_init, train_state_init
from repro_torch.train.optim import tree_map

ARCH = "qwen1.5-4b"
ATOL = 1e-4
FLAGS = ["--smoke", "--seq-len", "16", "--batch", "2"]


def _ref_state(steps: int) -> dict:
    return ref_train_state_init(jax.random.PRNGKey(0), ref_smoke_config(ARCH),
                                RefAdamWConfig(total_steps=steps)).as_dict()


def _reference_start(steps: int):
    """A stand-in for the port's ``train_state_init`` returning the
    reference driver's initial state."""
    tree = jax.tree.map(np.asarray, _ref_state(steps)["params"])

    def init(generator, cfg, opt_cfg):
        params = from_reference_params(tree, cfg)
        return TrainState(params, adamw_init(opt_cfg, params))

    return init


def _at(tree, key, index):
    for k in key:
        tree = tree[k]
    leaf = np.asarray(tree.float() if isinstance(tree, torch.Tensor) else tree, np.float32)
    return leaf if index is None else leaf[index]


def _port_like(steps: int) -> dict:
    """The port's state tree (its structure and shapes) on the CPU."""
    with set_backend(device="cpu"):
        cfg = get_smoke_config(ARCH)
        state = train_state_init(torch.Generator().manual_seed(0), cfg,
                                 AdamWConfig(total_steps=steps))
    return state, state.tree()


def test_port_driver_writes_the_reference_drivers_checkpoint(tmp_path, monkeypatch, capsys):
    steps = 3
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_launch.main([*FLAGS, "--arch", ARCH, "--steps", str(steps),
                     "--ckpt-dir", str(ref_dir)])
    monkeypatch.setattr(launch, "train_state_init", _reference_start(steps))
    launch.main([*FLAGS, "--arch", ARCH, "--steps", str(steps), "--ckpt-dir", str(port_dir),
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(f"finished at step {steps}") == 2 and "resumed" not in out
    assert latest_step(str(ref_dir)) == latest_step(str(port_dir)) == steps
    state, like = _port_like(steps)
    names = reference_names(state.params)
    # the reference's checkpoint through the port's reader, the port's
    # through the reference's
    ref_tree = restore_checkpoint(str(ref_dir), steps, _ref_state(steps))
    port_like = tree_map(lambda t: np.zeros(t.shape, np.float32), like)
    port_tree = ref_restore(str(port_dir), steps, port_like)
    assert ref_tree["opt"]["m"]["embed"]["table"].dtype == torch.bfloat16
    for part in ("params", "m", "v"):
        got_root = port_tree["params"] if part == "params" else port_tree["opt"][part]
        want_root = ref_tree["params"] if part == "params" else ref_tree["opt"][part]
        for name, (key, index) in names.items():
            got = _at(got_root, name.split("."), None)
            want = _at(want_root, key, index)
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"{part} {name}")
    assert int(port_tree["opt"]["step"]) == int(ref_tree["opt"]["step"]) == steps
    moved = float(np.abs(_at(port_tree["params"], ("final_norm", "g"), None) - 1).max())
    assert moved > 0  # the steps updated the parameters


def test_a_second_run_resumes_from_the_last_checkpoint(tmp_path, capsys):
    flags = [*FLAGS, "--arch", ARCH, "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    launch.main([*flags, "--steps", "3"])
    assert "resumed" not in capsys.readouterr().out
    launch.main([*flags, "--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "finished at step 4" in out
    assert "step     0" not in out  # the loop took up at step 3
    assert latest_step(str(tmp_path)) == 4


def test_both_drivers_need_frames_for_whisper(tmp_path):
    with pytest.raises(KeyError, match="frames"):
        ref_launch.main(["--smoke", "--arch", "whisper-medium", "--steps", "1", "--seq-len",
                         "8", "--batch", "2", "--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(KeyError, match="frames"):
        launch.main(["--smoke", "--arch", "whisper-medium", "--steps", "1", "--seq-len", "8",
                     "--batch", "2", "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])


def test_production_mesh_waits_for_parallel(tmp_path):
    """Without a launcher's rendezvous ``--production-mesh`` refuses to run,
    naming the world of 256 ranks it needs, and writes nothing (it never
    falls back to one device)."""
    with pytest.raises(RuntimeError, match="world size 256"):
        launch.main(["--smoke", "--production-mesh", "--ckpt-dir", str(tmp_path),
                     "--device", "cpu"])
    assert latest_step(str(tmp_path)) is None


def test_default_checkpoint_folder_is_per_arch_under_the_temp_dir(tmp_path, monkeypatch, capsys):
    """Without ``--ckpt-dir`` each arch and config keeps its checkpoints in
    a folder of its own under ``tempfile.gettempdir()``: a run of one arch
    never resumes from another's."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    launch.main([*FLAGS, "--arch", ARCH, "--steps", "1", "--device", "cpu"])
    launch.main([*FLAGS, "--arch", "mamba2-130m", "--steps", "1", "--device", "cpu"])
    assert "resumed" not in capsys.readouterr().out
    for arch in (ARCH, "mamba2-130m"):
        folder = tmp_path / "repro_torch_train" / f"{arch}-smoke"
        assert launch.default_ckpt_dir(arch, True) == str(folder)
        assert latest_step(str(folder)) == 1


@pytest.fixture(scope="module")
def mesh_driver(tmp_path_factory):
    """The driver's sharded loop on 4 gloo ranks (``torch_parallel_ranks``'s
    ``launch`` task): rank 0's losses and each rank's refusal of
    ``--production-mesh`` in a world of 4."""
    out = tmp_path_factory.mktemp("launch_mesh")
    ranks.wait_all(ranks.start_ranks("launch", 4, out))
    return [torch.load(out / f"launch_rank{r}.pt") for r in range(4)]


def test_production_mesh_loop_trains_and_resumes_as_the_single_device_driver(
        mesh_driver, tmp_path, capsys):
    flags = ["--smoke", "--arch", ARCH, "--seq-len", "16", "--batch", "4", "--device", "cpu",
             "--ckpt-dir", str(tmp_path)]
    want = launch.train(launch.parse_args([*flags, "--steps", "3"]))
    want += launch.train(launch.parse_args([*flags, "--steps", "5"]))
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(want) == 5
    for r in mesh_driver:
        assert len(r["losses"]) == 5
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=ATOL)


def test_production_mesh_refuses_a_world_that_is_not_256(mesh_driver):
    for r in mesh_driver:
        assert "world size 256" in r["refused"] and "has 4" in r["refused"]
