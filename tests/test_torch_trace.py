"""The trace annotations of gsplat_tpu_torch.utils.trace: the JAX helper
API (gsplat_tpu.utils.trace) on torch.profiler.record_function, and the
span and counter recorder.  Every range shows by name in a torch.profiler
trace, nested ranges inside their parent; a recording keeps spans with
their parents, threads and units, reads counters once when it closes,
and changes nothing a step, a render or their gradients compute."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import trace
from gsplat_tpu_torch.utils import trace_function, trace_pop, trace_push, trace_range

sys.path.insert(0, str(Path(__file__).resolve().parent))

# the spans of PERF.md §3, by first appearance in a training step's unit;
# a 3DGS step's projection and SH colours are one `project` pass each way
# (ops/projection_kernel.py:project_shade_grad), with no `project.sh` span
TRAIN_SPANS = ["train.step", "project", "project.sh", "plan", "sort", "composite", "loss",
               "backward", "loss.bwd", "composite.bwd", "reduce.bwd", "project.bwd",
               "optimizer", "strategy"]
TRAIN_SPANS_3DGS = [s for s in TRAIN_SPANS if s != "project.sh"]
# a request needs no gradient: its projection and SH colours are one
# `project` pass (ops/projection_kernel.py), with no `project.sh` span
SERVE_SPANS = ["serve.request", "project", "plan", "sort", "composite"]


def test_trace_ranges_show_in_a_profiler_trace():
    @trace_function()
    def decorated(x):
        return x * 2

    @trace_function("named_fn")
    def named(x):
        return x + 1

    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_range("outer_range"):
            trace_push("pushed_range")
            y = decorated(x) @ x
            trace_pop()
            named(y)
    events = {e.name: e for e in prof.events()}
    for name in ("outer_range", "pushed_range", "named_fn",
                 "test_trace_ranges_show_in_a_profiler_trace.<locals>.decorated"):
        assert name in events, name
    outer, pushed = events["outer_range"].time_range, events["pushed_range"].time_range
    assert outer.start <= pushed.start and pushed.end <= outer.end
    trace_pop()  # an empty stack pops nothing


def _tree(rec):
    """{span name: parent's name} and the names in first-appearance order."""
    by_index = {s.index: s for s in rec.spans}
    parents = [(s.name, by_index[s.parent].name if s.parent >= 0 else None) for s in rec.spans]
    order = list(dict.fromkeys(s.name for s in rec.spans))
    return parents, order


def test_recorded_spans_nest_with_their_parents_and_units():
    with trace.recording() as rec:
        for _ in range(2):
            with trace_range("unit"):
                with trace_range("a"):
                    trace_push("b")
                    trace_pop()
                with trace_range("c"):
                    pass
    names = [(s.name, s.parent, s.unit) for s in rec.spans]
    assert names == [("unit", -1, 0), ("a", 0, 0), ("b", 1, 0), ("c", 0, 0),
                     ("unit", -1, 4), ("a", 4, 4), ("b", 5, 4), ("c", 4, 4)]
    for s in rec.spans:
        assert 0 < s.t0 <= s.t1
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    assert trace._rec is None


class _Marked(torch.autograd.Function):
    """x * 2, whose backward opens a span."""

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        with trace_range("inside.bwd"):
            return g * 2


def test_stacks_are_per_thread_and_a_backward_span_finds_its_parent():
    """A span on another thread nests under that thread's own open span,
    or, with none open there, under the recording thread's innermost; a
    push on one thread is not popped by another.  The backward of a custom
    Function runs on a worker thread while the main thread waits in its
    `backward` span, as autograd's device thread does on the card."""
    x = torch.randn(8, requires_grad=True)
    loss = _Marked.apply(x).sum()
    with trace.recording() as rec:
        with trace_range("step"):
            trace_push("main.pushed")

            def worker():
                trace_pop()  # nothing pushed on this thread: pops nothing
                with trace_range("w.outer"):
                    with trace_range("w.inner"):
                        pass

            t = threading.Thread(target=worker)
            t.start()
            t.join()
            trace_pop()
            with trace_range("backward"):
                t = threading.Thread(target=loss.backward)
                t.start()
                t.join()
    parents, _ = _tree(rec)
    assert parents == [("step", None), ("main.pushed", "step"), ("w.outer", "main.pushed"),
                       ("w.inner", "w.outer"), ("backward", "step"),
                       ("inside.bwd", "backward")]
    main, other = rec.spans[0].thread, rec.spans[2].thread
    assert main != other and rec.spans[5].thread != main
    assert {s.unit for s in rec.spans} == {0}
    assert torch.equal(x.grad, torch.full_like(x, 2.0))


def test_off_nothing_is_recorded_and_no_object_is_made(monkeypatch):
    assert trace_range("a") is trace_range("b")  # one shared null context
    hooks = []
    monkeypatch.setattr(torch.Tensor, "register_hook", lambda self, fn: hooks.append(fn))
    x = torch.randn(4, requires_grad=True)
    trace.backward_phase("loss.bwd", x)
    trace.count("plan.isects", torch.tensor(3))
    with trace_range("a"):
        trace_push("b")
        trace_pop()
    assert hooks == [] and trace._rec is None
    with trace.recording() as rec:
        trace.backward_phase("loss.bwd", x)
    assert len(hooks) == 1 and rec.spans == [] and rec.counters == []
    with pytest.raises(RuntimeError):
        with trace.recording():
            with trace.recording():
                pass


def test_counters_are_read_once_when_the_recording_closes(monkeypatch):
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda self: reads.append(1) or item(self))
    v = torch.tensor(5, dtype=torch.int32)
    with trace.recording() as rec:
        trace.count("outside", 1)
        with trace_range("unit"):
            trace.count("plan.isects", v)
            trace.count("plan.capacity", 512)
        v += 2  # read at the close, not when counted
        assert reads == []
    assert reads == [1]
    assert rec.counters == [("outside", -1, 1.0), ("plan.isects", 0, 7.0),
                            ("plan.capacity", 0, 512.0)]


def _trainers(cls, cfg_cls, tmp_path, **kw):
    from test_torch_trainer import _cfg_kw, _tiny_data

    make = lambda d: cls(cfg_cls(**_cfg_kw(tmp_path / d, tb_every=0, **kw)),
                         data=_tiny_data(), device="cpu")
    return make("off"), make("on")


def _bitwise(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _bitwise(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _bitwise(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_a_recorded_training_step_is_bitwise_the_unrecorded_one(kind, tmp_path):
    """The same step recorded and not: the loss, the gradients, the screen
    gradient and the parameters, moments and alive mask after the step are
    equal bit for bit; the recorded step's unit holds every span of the
    table in order, and its plan's counters (3DGS: after the training
    route's rows)."""
    if kind == "3dgs":
        from gsplat_tpu_torch.trainer import Config, Trainer

        off, on = _trainers(Trainer, Config, tmp_path)
    else:
        from gsplat_tpu_torch.trainer_2dgs import Config2DGS, Trainer2DGS

        off, on = _trainers(Trainer2DGS, Config2DGS, tmp_path, strategy="default",
                            normal_start_iter=0, dist_start_iter=0)
    targets = off._make_npz_targets()[:2]
    vms, Ks = torch.from_numpy(off.viewmats[:2]), torch.from_numpy(off.Ks[:2])
    args = (vms[:1], Ks[:1], targets[:1], 1)
    a = off.train_step(off.params, off.alive, *args, step=4)
    with trace.recording():
        b = on.train_step(on.params, on.alive, *args, step=4)
    _bitwise(a[:3], b[:3])
    off.run_step(4, np.array([1]), vms, Ks, targets)
    with trace.recording() as rec:
        on.run_step(4, np.array([1]), vms, Ks, targets)
    _bitwise((off.params, off.opt_state, off.alive), (on.params, on.opt_state, on.alive))
    parents, order = _tree(rec)
    assert order == (TRAIN_SPANS_3DGS if kind == "3dgs" else TRAIN_SPANS)
    assert {s.unit for s in rec.spans} == {0}
    assert ("composite.bwd", "backward") in parents and ("reduce.bwd", "composite.bwd") in parents
    assert ("project.bwd", "backward") in parents and ("loss.bwd", "backward") in parents
    counters = {c.name: c.value for c in rec.counters}
    names = ["plan.isects", "plan.capacity"]
    if kind == "3dgs":
        names = ["project.fused_grad"] + names
        assert counters["project.fused_grad"] == on.capacity
    assert [c.name for c in rec.counters] == names and counters["plan.isects"] > 0


def test_a_recorded_fast_path_render_is_bitwise_the_unrecorded_one():
    from gsplat_tpu_torch.scene import GaussianInferenceScene, render_scene

    rng = np.random.default_rng(0)
    n = 300
    q = rng.standard_normal((n, 4)).astype(np.float32)
    scene = GaussianInferenceScene.from_gaussian_tensors(
        rng.uniform(-1, 1, (n, 3)).astype(np.float32), q / np.linalg.norm(q, axis=1)[:, None],
        rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32),
        rng.uniform(0.2, 0.9, n).astype(np.float32),
        rng.standard_normal((n, 4, 3)).astype(np.float32) * 0.3, 1, id="t", device="cpu")
    vm = torch.eye(4)
    vm[2, 3] = 4.0
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    kw = dict(viewmat=vm, K=K, width=64, height=48, isect_capacity=1 << 14)
    a = render_scene(scene, **kw)
    with trace.recording() as rec:
        b = render_scene(scene, **kw)
    _bitwise(a[:2], b[:2])
    _bitwise(a[2]["n_isects"], b[2]["n_isects"])
    assert _tree(rec)[1] == SERVE_SPANS
    assert [c.name for c in rec.counters] == ["project.fused", "plan.isects", "plan.capacity"]
    assert rec.counters[0].value == 300


def _gut_render(leaves):
    from gsplat_tpu_torch.rendering import rasterization

    vm = torch.eye(4)
    vm[2, 3] = 4.0
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    img, alpha, meta = rasterization(
        *leaves, vm[None], K[None], 64, 48, sh_degree=1, isect_capacity=1 << 14,
        with_ut=True, with_eval3d=True, radial_coeffs=torch.tensor([[0.08, -0.02, 0.004]]))
    (img.square().sum() + alpha.sum()).backward()
    return img.detach(), alpha.detach(), [t.grad for t in leaves]


def test_a_recorded_3dgut_render_and_backward_open_the_eval3d_spans():
    """A 3DGUT render (UT projection, rays of a distorting pinhole, K7a's
    plain version) and its backward, recorded and not: equal bit for bit;
    the UT under `project.ut` with its counter of I x N rows, the rays
    under `project.rays`, the composite and its backward in `composite`,
    `composite.bwd` and `reduce.bwd`, and the AABB plan's counters."""
    rng = np.random.default_rng(1)
    n = 300
    q = rng.standard_normal((n, 4)).astype(np.float32)
    raw = [rng.uniform(-1, 1, (n, 3)), q / np.linalg.norm(q, axis=1)[:, None],
           rng.uniform(0.02, 0.1, (n, 3)), rng.uniform(0.2, 0.9, n),
           rng.standard_normal((n, 4, 3)) * 0.3]
    make = lambda: [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in raw]
    a = _gut_render(make())
    with trace.recording() as rec:
        b = _gut_render(make())
    _bitwise(a, b)
    parents, order = _tree(rec)
    assert order == ["project", "project.ut", "project.sh", "project.rays", "plan", "sort",
                     "composite", "composite.bwd", "reduce.bwd", "project.bwd"]
    for child, parent in [("project.ut", "project"), ("project.rays", "project"),
                          ("reduce.bwd", "composite.bwd")]:
        assert (child, parent) in parents
    assert [c.name for c in rec.counters] == ["project.ut", "plan.isects", "plan.capacity"]
    assert rec.counters[0].value == 1 * n and rec.counters[1].value > 0
