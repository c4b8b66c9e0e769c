"""The port's tracer (raisimlib_torch/utils/profiling.py: span, tracing,
records, reset) and portbench's three readers of its spans:

  * off, `span` records nothing and returns one shared no-op;
  * on, one MPPI update through make_contact_dyn_batch(fused="require")
    (ANYmal on K1's CPU twin, 1 x 3 samples, H 2, 1 substep) gives the
    tree: one `mppi.update` holding `mppi.noise`, H + 1 `mppi.cost`, H
    `dyn.call` with one `k1.step` each (no `k1.enqueue`: the twin launches
    nothing) and `mppi.weights`, every span inside its parent;
  * clock: under torch.profiler, each span's start and end lie within
    0.5 ms of its own event's (an operator event, and no range on the
    device's timeline), the median under 50 us;
  * `mppi_ramp_ms.mpc`, `k1_wrapper_us.mpc` and `k1_enqueue_us.mpc` on
    records made by hand read the values worked out by hand, and None
    where there are no records;
  * on the card, each `k1.enqueue` names the width its launch took.
"""

import os
import statistics

import pytest
import torch

from torch_port_util import one_thread, torch_anymal_scene  # noqa: F401  (a module fixture)

from raisimlib_torch.utils import profiling
from raisimlib_torch.utils.profiling import Record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_records():
  profiling.reset()
  yield
  profiling.reset()


def test_off_span_is_one_shared_no_op():
  a = profiling.span("k1.step", B=4)
  assert a is profiling.span("mppi.update", E=1, K=2, H=3)
  with a:
    with profiling.span("dyn.call"):
      pass
  assert profiling.records() == []


def test_on_records_nest_and_close():
  with profiling.tracing():
    with profiling.span("outer", n=1):
      with profiling.span("inner"):
        pass
      with pytest.raises(RuntimeError):
        profiling.reset()
    with pytest.raises(ValueError), profiling.span("raises"):
      raise ValueError
  assert profiling.span("after") is profiling.span("tracing is off")
  recs = profiling.records()
  assert [(r.name, r.parent, r.attrs) for r in recs] == [
      ("outer", -1, {"n": 1}), ("inner", 0, {}), ("raises", -1, {})]
  assert all(r.end_ns is not None and r.start_ns <= r.end_ns for r in recs)
  assert recs[0].start_ns <= recs[1].start_ns <= recs[1].end_ns <= recs[0].end_ns


def test_one_mppi_update_gives_the_span_tree():
  from raisimlib_torch.mpc.mppi import MPPIConfig, mppi_step_batch
  from raisimlib_torch.mpc.state_map import make_contact_dyn_batch

  scene = torch_anymal_scene(dtype=torch.float32)
  E, K, H = 1, 3, 2
  dyn, nx, nu = make_contact_dyn_batch(scene, scene.dt, 1, use_pd=True, fused="require")
  q0 = scene.model.q_init.to(torch.float32)
  x0 = torch.cat([q0, torch.zeros(nx - q0.numel())])[None].repeat(E, 1)
  U = q0[7:].expand(E, H, nu).clone()

  def rc(X, A, t):
    return (A ** 2).sum(1)

  def fc(X):
    return X[:, 2]

  with profiling.tracing(), torch.inference_mode():
    mppi_step_batch(dyn, rc, fc, x0, U, generator=torch.Generator().manual_seed(0),
                    config=MPPIConfig(n_samples=K))
  recs = profiling.records()
  names = [r.name for r in recs]
  assert names.count("mppi.update") == 1 and recs[0].name == "mppi.update"
  assert recs[0].parent == -1 and recs[0].attrs == {"E": E, "K": K, "H": H}
  kids = [r.name for r in recs if r.parent == 0]
  assert kids == ["mppi.noise"] + ["mppi.cost", "dyn.call"] * H + ["mppi.cost", "mppi.weights"]
  calls = [i for i, r in enumerate(recs) if r.name == "dyn.call"]
  assert all(recs[i].attrs == {"B": E * K, "substeps": 1} for i in calls)
  steps = [r for r in recs if r.name == "k1.step"]
  assert sorted(r.parent for r in steps) == calls and all(r.attrs == {"B": E * K} for r in steps)
  assert "k1.enqueue" not in names
  for r in recs[1:]:
    p = recs[r.parent]
    assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (r, p)


def test_spans_are_on_the_profilers_clock():
  from torch.profiler import ProfilerActivity, profile

  x = torch.ones(16)
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with torch.profiler.record_function("warm-up"):
      pass
    for i in range(100):
      with profiling.span(f"clock.{i}"):
        x = x + 1.0
  ours = {r.name: r for r in profiling.records()}
  assert len(ours) == 100
  events = [e for e in prof.profiler.kineto_results.events() if e.name() in ours]
  assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in events)
  theirs = {e.name(): e for e in events}
  assert len(events) == len(theirs) and set(theirs) == set(ours)
  gaps = []
  for name, r in ours.items():
    s, e = _ns(theirs[name])
    gaps += [abs(s - r.start_ns), abs(e - r.end_ns)]
  assert max(gaps) < 500_000, max(gaps)
  assert statistics.median(gaps) < 50_000, statistics.median(gaps)


def _ns(e):
  """(start, end) of a profiler event in ns (older torch gives us only)."""
  if hasattr(e, "start_ns"):
    return e.start_ns(), e.end_ns()
  s = int(e.start_us() * 1000)
  return s, s + int(e.duration_us() * 1000)


def _reader(name):
  from portbench.run import module

  return module("layer_metrics", name, ROOT).read


def _records():
  """Two updates and the plant's call between them (times in us, each
  span's parent by index):

    0 mppi.update 0-10000            9 dyn.call (plant) 10100-10500
    1   mppi.noise 100-600          10   k1.step 10150-10450
    2   mppi.cost 700-1200          11     k1.enqueue 10400-10440
    3   dyn.call 1300-1900          12 mppi.update 11000-20000
    4     k1.step 1400-1500         13   mppi.cost 11100-13000
    5       k1.enqueue 1450-1470    14   dyn.call 13050-13500
    6     k1.step 1600-1700         15     k1.step 13100-13400
    7       k1.enqueue 1610-1640    16       k1.enqueue 13200-13210
    8   mppi.weights 9000-9900      17     k1.step 13410-13490 (no launch)
  """
  rows = [("mppi.update", 0, 10000, -1), ("mppi.noise", 100, 600, 0),
          ("mppi.cost", 700, 1200, 0), ("dyn.call", 1300, 1900, 0),
          ("k1.step", 1400, 1500, 3), ("k1.enqueue", 1450, 1470, 4),
          ("k1.step", 1600, 1700, 3), ("k1.enqueue", 1610, 1640, 6),
          ("mppi.weights", 9000, 9900, 0), ("dyn.call", 10100, 10500, -1),
          ("k1.step", 10150, 10450, 9), ("k1.enqueue", 10400, 10440, 10),
          ("mppi.update", 11000, 20000, -1), ("mppi.cost", 11100, 13000, 12),
          ("dyn.call", 13050, 13500, 12), ("k1.step", 13100, 13400, 14),
          ("k1.enqueue", 13200, 13210, 15), ("k1.step", 13410, 13490, 14)]
  t0 = 1_792_000_000_000_000_000
  return [Record(n, t0 + 1000 * a, t0 + 1000 * b, p, {}) for n, a, b, p in rows]


@pytest.mark.parametrize("name, value", [
    ("mppi_ramp_ms.mpc", (1.450 + 2.200) / 2),        # 0 -> 5, 12 -> 16
    ("k1_wrapper_us.mpc", (80 + 260) / 2),             # median of 80, 70, 260, 290
    ("k1_enqueue_us.mpc", (20 + 30 + 40 + 10) / 4),
], ids=["mppi_ramp_ms", "k1_wrapper_us", "k1_enqueue_us"])
def test_readers_on_records_made_by_hand(monkeypatch, name, value):
  read = _reader(name)
  assert read(None) is None                            # nothing recorded
  monkeypatch.setattr(profiling, "records", _records)
  assert read(None) == pytest.approx(value, rel=1e-12)


@pytest.mark.cuda
def test_k1_enqueue_names_its_width():
  """On the card, each K1 launch's `k1.enqueue` span carries its batch, the
  lanes per world the width rule took (32 at B = 384, one wave of one-world
  blocks on an H100; 8 at B = 16384) and whether that build calls the cone
  solve out of line (ANYmal's builds both do: `solve_called`), which
  `launches_called` counts."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  from raisimlib_torch.ops import gpu_step
  from raisimlib_torch.ops.integrator import State

  scene = torch_anymal_scene(dtype=torch.float32, device="cuda")
  step = gpu_step.make_step_batch_fused(scene)
  q0 = scene.model.q_init.to(torch.float32)
  pd = torch.cat([torch.zeros(6, device="cuda"), q0[7:]])
  n0 = gpu_step.make_step_batch_fused.launches_called
  with profiling.tracing(), torch.inference_mode():
    for B in (384, 16384):
      s = State(q=q0.repeat(B, 1), u=torch.zeros((B, 18), device="cuda"),
                t=torch.zeros(B, device="cuda"))
      step(s, torch.zeros((B, 18), device="cuda"), pd.repeat(B, 1))
    torch.cuda.synchronize()
  recs = [r for r in profiling.records() if r.name == "k1.enqueue"]
  assert [r.attrs for r in recs] == [{"B": 384, "lanes": gpu_step.WIDE, "solve": "called"},
                                     {"B": 16384, "lanes": gpu_step.LANES, "solve": "called"}]
  assert gpu_step.make_step_batch_fused.launches_called == n0 + 2
