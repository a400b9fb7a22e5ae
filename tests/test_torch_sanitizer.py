"""The port's runtime sanitizers wired into its engines, as
``tests/test_runtime_sanitizer.py`` wires the reference's.

``ServeEngine(debug=True)`` arms a ``BufferGuard`` around every decode
step: the fixed engine runs clean and generates the tokens of an
unguarded engine, and re-introducing the zero-copy alias (handing the
step a ``torch.from_numpy`` view of the live position buffer) is caught.
The control plane checks its event heap every tick under ``debug=True``,
and the process-wide switch arms new engines and planes.  On the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import runtime as sanitizers
from repro_torch.analysis.runtime import SanitizerError
from repro_torch.backend import set_backend


@pytest.fixture(autouse=True)
def _sanitizers_restore():
    prev = sanitizers.enabled()
    with set_backend(device="cpu"):
        yield
    (sanitizers.enable if prev else sanitizers.disable)()


# -- ServeEngine integration ------------------------------------------------


def _tiny_engine(debug):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_smoke_config("qwen1.5-4b")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    return ServeEngine(params, cfg, batch_slots=2, max_len=32, eos_token=-1, debug=debug)


def _serve(eng, prompts):
    from repro_torch.serve.engine import Request

    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid, np.array(prompt, np.int32), max_new_tokens=3))
    done = []
    for _ in range(30):
        done += eng.step()
        if len(done) == len(prompts):
            break
    return {r.request_id: r.generated for r in done}


def test_serve_engine_clean_under_debug():
    eng = _tiny_engine(debug=True)
    assert eng._guard is not None
    got = _serve(eng, [[5, 7], [3, 4, 9], [11]])
    assert len(got) == 3 and all(len(g) == 3 for g in got.values())
    assert len(eng._guard) == 0  # every capture verified at its step's host read
    assert got == _serve(_tiny_engine(debug=False), [[5, 7], [3, 4, 9], [11]])


def test_serve_engine_guard_catches_injected_alias():
    """Re-introduce the aliasing race: hand the decode step a view of the
    live ``_pos`` buffer instead of a copy.  The guard must refuse at the
    handoff (alias) or at the next host read (mutation)."""
    from repro_torch.serve.engine import Request

    eng = _tiny_engine(debug=True)

    def buggy_with_pos():
        cache = dict(eng.cache)
        dev = torch.from_numpy(eng._pos)  # zero-copy on the CPU
        cache["pos"] = dev
        eng._guard.capture("pos", eng._pos, dev)
        return cache

    eng._with_pos = buggy_with_pos
    eng.submit(Request(0, np.array([5, 7], np.int32), max_new_tokens=3))
    with pytest.raises(SanitizerError, match="aliases the live host buffer"):
        for _ in range(10):
            eng.step()


def test_serve_engine_guard_catches_a_mutation_past_a_copy():
    """A copy that still changes between handoff and the host read is
    caught by the snapshot comparison."""
    eng = _tiny_engine(debug=True)
    pos = eng._pos.copy()
    dev = torch.tensor(pos)
    eng._guard.capture("pos", pos, dev)
    dev += 1  # the launched value moves after the handoff
    with pytest.raises(SanitizerError, match="changed between handoff"):
        eng._guard.verify()


def test_process_wide_enable_arms_new_engines():
    sanitizers.enable()
    eng = _tiny_engine(debug=False)
    assert eng.debug and eng._guard is not None


# -- ControlPlane integration -----------------------------------------------


def _plane(**kw):
    from repro_torch.runtime.loop import ControlPlane

    return ControlPlane(n_servers=4, policy="wf", **kw)


def _jobs(n=6, seed=0):
    from repro_torch.traces.bursty import BurstyTraceConfig, generate_bursty_trace

    return generate_bursty_trace(BurstyTraceConfig(n_jobs=n, n_servers=4, seed=seed))


def test_control_plane_debug_run_checks_heap_every_tick():
    plane = _plane(debug=True)
    plane.submit_many(_jobs())
    plane.drain()
    res = plane.result()
    assert len(res.jct) == 6 and np.isfinite(res.mean_jct)


def test_control_plane_debug_catches_corrupted_heap():
    plane = _plane(debug=True)
    plane.submit_many(_jobs())
    plane._heap.append((10**9, 0, 999_999, "dup-a"))
    plane._heap.append((10**9, 0, 999_999, "dup-b"))
    with pytest.raises(SanitizerError, match="duplicate"):
        plane.drain()


def test_control_plane_debug_matches_plain_run():
    jcts = []
    for debug in (False, True):
        plane = _plane(debug=debug)
        plane.submit_many(_jobs(n=10, seed=4))
        plane.drain()
        res = plane.result()
        jcts.append((res.mean_jct, res.makespan))
    assert jcts[0] == jcts[1]


def test_process_wide_enable_arms_new_planes():
    sanitizers.enable()
    plane = _plane(debug=False)
    assert plane.debug
