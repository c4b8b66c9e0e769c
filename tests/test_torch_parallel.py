"""The port's parallel layer (raisimlib_torch/parallel) on 4 gloo ranks
against the JAX package's on meshes of the same sizes over the conftest's 8
virtual CPU devices, the cases of tests/test_parallel.py,
tests/test_qp_shard.py, tests/test_scaling_bound.py and
tests/test_distributed.py, in f64.

The ranks run once per module: a module fixture launches 4 processes of
tests/torch_dist_worker.py with torchrun's launcher variables (env-var
init through `parallel.init_distributed`, two "hosts" of two ranks), which
run every port-side case while this process computes JAX's; each test then
compares one case. Tolerances:

  * the sharded rollout of falling spheres (B = 16, H = 40, meshes of 1, 2
    and 4 ranks): 1e-9 against JAX's make_sharded_rollout on 4 devices (the
    K2 twin against JAX's Pallas kernel in interpret mode, f64; JAX's own
    tests/test_parallel.py holds its sharded rollout to the unsharded one,
    and each extra mesh costs a JAX compile of seconds);
  * the sharded iLQR, the sharded MPPI (JAX's noise): rtol 1e-7;
  * multishoot_solve at S = 4: rtol 1e-6 on U, knots, cost and the defect
    trace, with atol 1e-6 on U, whose entries pass through zero (measured
    here: U within 1.1e-7 of JAX's on |U| up to 0.56, in the consensus
    segments only, the last segment's to round-off; knots within 6.5e-10;
    the cost within 2e-12 relative; the defect traces equal to 7 digits);
  * the sharded contact solve at qp = 4 and (dp, qp) = (2, 2): 1e-9;
  * collectives: the rollout issues none, the iLQR exactly its two scalar
    all_reduces, the MPPI one.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from torch_port_util import one_thread  # noqa: F401  (a module fixture)

from raisimlib_tpu.parallel import make_mesh, shard_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
N_RANKS = 4
MPPI_B, MPPI_ITERS, MPPI_K, MPPI_H = 8, 3, 16, 10


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def jax_cartpole():
  """tests/test_parallel.py's cartpole problem, f64."""
  from raisimlib_tpu.models import primitives
  from raisimlib_tpu.mpc import make_smooth_dyn

  model = primitives.cartpole(dtype=jnp.float64)
  dyn, nx, nu = make_smooth_dyn(model, jnp.array([0.0, 0.0, -9.81]), dt=0.02, substeps=1)

  def rc(x, u, t):
    return (4.0 * (jnp.cos(x[1]) + 1.0) + 0.1 * x[0] ** 2 + 0.01 * jnp.sum(u ** 2)) * 0.02

  def fc(x):
    return 40.0 * (jnp.cos(x[1]) + 1.0) + 2.0 * x[0] ** 2 + x[2] ** 2 + x[3] ** 2

  return dyn, nx, nu, rc, fc


def _mppi_noise():
  """The white noise JAX's receding_horizon draws for scenario b (keys
  split from PRNGKey(0)), iteration i: (B, n_iters, K, H, nu)."""
  keys = jax.random.split(jax.random.PRNGKey(0), MPPI_B)
  draw = jax.vmap(lambda k: jax.vmap(lambda ki: 0.5 * jax.random.normal(
      ki, (MPPI_K, MPPI_H, 1), jnp.float64))(jax.random.split(k, MPPI_ITERS)))
  return np.asarray(jax.jit(draw)(keys))


ONE_RANK = """
import os
for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
  os.environ.pop(k, None)
import torch, torch.distributed as dist
from raisimlib_torch import parallel
dev = parallel.init_distributed(device="cpu")
assert parallel.init_distributed(device="cpu") == dev and dev.type == "cpu"
assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
m = parallel.make_mesh()
x = {"a": torch.arange(6.0).reshape(3, 2), "t": torch.tensor(2.0)}
s = parallel.shard_batch(m, x)
assert torch.equal(s["a"], x["a"]) and torch.equal(parallel.gather_batch(m, s)["a"], x["a"])
try:
  parallel.make_mesh(2)
  raise SystemExit("a 2-rank mesh in a world of 1")
except ValueError:
  pass
dist.destroy_process_group()
print("ONE_RANK_OK")
"""


class Ranks:
  """The 4 worker processes, the one-rank process, and, once they end, each
  rank's results."""

  def __init__(self, d, procs, one):
    self.d, self.procs, self.one, self._res = d, procs, one, None

  def one_rank_output(self):
    return self.one.communicate(timeout=120)[0]

  def result(self, rank=0):
    if self._res is None:
      outs = []
      try:
        for p in self.procs:
          outs.append(p.communicate(timeout=240)[0])
      finally:
        for p in self.procs:
          if p.poll() is None:
            p.kill()
      for r, (p, out) in enumerate(zip(self.procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r}:\n{out[-4000:]}"
      self._res = [dict(np.load(self.d / f"rank{r}.npz")) for r in range(N_RANKS)]
    return self._res[rank]


def _save_atomic(path, **arrays):
  """np.savez through a tmp file and os.replace: a rank never reads half a file."""
  tmp = path.with_suffix(".tmp.npz")
  np.savez(tmp, **arrays)
  os.replace(tmp, path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  """Launches the ranks first; they wait for the inputs written here (the
  MPPI noise, the contact problems) only when they reach those cases."""
  from torch_dist_worker import qp_problems

  d = tmp_path_factory.mktemp("ranks")
  env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
             WORLD_SIZE=str(N_RANKS), LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1",
             PYTHONPATH=REPO)
  procs = [subprocess.Popen([sys.executable, WORKER, str(d)], cwd=REPO,
                            env=dict(env, RANK=str(r), LOCAL_RANK=str(r % 2)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in range(N_RANKS)]
  one = subprocess.Popen([sys.executable, "-c", ONE_RANK], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  _save_atomic(d / "mppi_eps.npz", eps=_mppi_noise())
  p4, p2 = qp_problems()
  _save_atomic(d / "qp.npz", **{f"{tag}_{k}": a for tag, p in (("qp", p4), ("qp2", p2))
                                for k, a in zip(("G", "c0", "mu", "active"), p)})
  yield Ranks(d, procs, one)
  for p in procs + [one]:
    if p.poll() is None:
      p.kill()


# ---- the sharded rollout --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_refs(ranks):
  """JAX's results of every case whose inputs the test knows, computed while
  the ranks run (the ranks fixture launches them first)."""
  from raisimlib_tpu.mpc import ILQRConfig
  from raisimlib_tpu.mpc.mppi import MPPIConfig
  from raisimlib_tpu.ops.integrator import State
  from raisimlib_tpu.parallel import (MultiShootConfig, make_sharded_ilqr, make_sharded_mppi,
                                      make_sharded_rollout, multishoot_solve)
  from raisimlib_tpu.parallel.qp_shard import make_sharded_contact_solver
  from raisimlib_tpu.world import World

  world = World(dt=0.002, dtype=jnp.float64)
  world.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.3))
  world.add_ground()
  scene = world.compile()
  B, H = 16, 40
  q0 = jnp.tile(scene.model.q_init[None], (B, 1)).at[:, 2].set(jnp.linspace(0.15, 0.5, B))
  s0 = State(q=q0, u=jnp.zeros((B, scene.model.nv)), t=jnp.zeros((B,)))
  mesh = make_mesh(N_RANKS)
  final, qs = make_sharded_rollout(scene, mesh)(
      *shard_batch(mesh, (s0, jnp.zeros((B, H, scene.model.nv)))))
  refs = {"rollout": (np.asarray(final.q), np.asarray(qs))}

  dyn, nx, nu, rc, fc = jax_cartpole()
  B, H = 16, 30
  x0s = jnp.zeros((B, nx)).at[:, 0].set(jnp.linspace(-0.5, 0.5, B))
  refs["ilqr"] = make_sharded_ilqr(dyn, rc, fc, mesh, ILQRConfig(iters=4))(
      *shard_batch(mesh, (x0s, jnp.zeros((B, H, nu)))))

  x0s = jnp.zeros((MPPI_B, nx)).at[:, 1].set(jnp.linspace(0.2, 0.6, MPPI_B))
  keys = jax.random.split(jax.random.PRNGKey(0), MPPI_B)
  solve = make_sharded_mppi(dyn, rc, fc, mesh, MPPI_ITERS,
                            MPPIConfig(n_samples=MPPI_K, sigma=0.5))
  refs["mppi"] = solve(*shard_batch(mesh, (x0s, jnp.zeros((MPPI_B, MPPI_H, nu)), keys)))

  cfg = MultiShootConfig(outer_iters=8, ilqr=ILQRConfig(iters=6), rho=20.0)
  refs["multishoot"] = cfg, multishoot_solve(dyn, rc, fc, jnp.zeros((nx,)).at[1].set(0.3),
                                             jnp.zeros((64, nu)), mesh, cfg)

  qp = np.load(ranks.d / "qp.npz")
  p4, p2 = ([qp[f"{tag}_{k}"] for k in ("G", "c0", "mu", "active")] for tag in ("qp", "qp2"))
  devs = np.array(jax.devices()[:4])
  solve4 = make_sharded_contact_solver(JMesh(devs, ("qp",)), qp_axis="qp", dp_axis=None,
                                       iters=128, omega=0.7)
  solve2 = make_sharded_contact_solver(JMesh(devs.reshape(2, 2), ("dp", "qp")), qp_axis="qp",
                                       dp_axis="dp", iters=128, omega=0.7)
  try:
    solve4(p4[0][:-1, :, :-1], p4[1][:-1], p4[2][:-1], p4[3][:-1])
    pad_error = ""
  except ValueError as e:
    pad_error = str(e)
  refs["qp"] = p4, np.asarray(solve4(*p4)), np.asarray(solve2(*p2)), pad_error
  return refs


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_rollout_matches_jax(ranks, jax_refs, n):
  """Every rank of the mesh gathers the same global batch; it equals JAX's
  sharded rollout, the spheres never pass into the plane, and the rollout
  issued no collective (the K2 path on the CPU: no fused step)."""
  q_j, qs_j = jax_refs["rollout"]
  for r in range(n):
    res = ranks.result(r)
    np.testing.assert_allclose(res[f"rollout{n}_q"], q_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res[f"rollout{n}_qs"], qs_j, rtol=0, atol=1e-9)
    assert res[f"rollout{n}_calls"].size == 0, res[f"rollout{n}_calls"]
    assert not bool(res[f"rollout{n}_fused"])
  assert res[f"rollout{n}_qs"][:, :, 2].min() > 0.095
  for r in range(n, N_RANKS):
    assert f"rollout{n}_q" not in ranks.result(r)


# ---- the sharded solvers --------------------------------------------------------------------


def test_sharded_ilqr_matches_jax(ranks, jax_refs):
  """The cartpole, B = 16 over 4 ranks, H = 30, 4 iterations (each world as
  `ilqr`, exact Jacobians): U and costs gathered, both metrics on every rank,
  and exactly the two scalar all_reduces of the metrics."""
  U, cost, metrics = jax_refs["ilqr"]
  for r in range(N_RANKS):
    res = ranks.result(r)
    np.testing.assert_allclose(res["ilqr_cost"], np.asarray(cost), rtol=1e-7)
    np.testing.assert_allclose(res["ilqr_U"], np.asarray(U), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(res["ilqr_mean"], float(metrics["mean_cost"]), rtol=1e-7)
    np.testing.assert_allclose(res["ilqr_max"], float(metrics["max_cost"]), rtol=1e-7)
    assert list(res["ilqr_calls"]) == ["all_reduce", "all_reduce"], res["ilqr_calls"]


def test_sharded_mppi_matches_jax(ranks, jax_refs):
  """The cartpole, 8 scenarios over 4 ranks, 3 receding-horizon iterations
  on the noise JAX drew: plans, the updated plans' costs, the mean cost on
  every rank, and one all_reduce."""
  U, cost, mean_cost = jax_refs["mppi"]
  for r in range(N_RANKS):
    res = ranks.result(r)
    np.testing.assert_allclose(res["mppi_U"], np.asarray(U), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(res["mppi_cost"], np.asarray(cost), rtol=1e-7)
    np.testing.assert_allclose(res["mppi_mean"], float(mean_cost), rtol=1e-7)
    assert list(res["mppi_calls"]) == ["all_reduce"], res["mppi_calls"]


def test_multishoot_matches_jax(ranks, jax_refs):
  """S = 4 segments on 4 ranks: the ring exchanges (two a round, one to
  start), the max of the defects each round, the all_gathers of the warm
  start and the stitch; JAX's solution; defects that close."""
  cfg, sol = jax_refs["multishoot"]
  for r in range(N_RANKS):
    res = ranks.result(r)
    np.testing.assert_allclose(res["ms_U"], np.asarray(sol.U), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res["ms_knots"], np.asarray(sol.knots), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res["ms_cost"], float(sol.cost), rtol=1e-6)
    np.testing.assert_allclose(res["ms_defects"], np.asarray(sol.defect_trace), rtol=1e-6,
                               atol=1e-9)
    calls = list(res["ms_calls"])
    assert calls.count("batch_isend_irecv") == 1 + 2 * cfg.outer_iters
    assert calls.count("all_reduce") == cfg.outer_iters
    assert calls.count("all_gather") == 3 and len(calls) == 4 + 3 * cfg.outer_iters
  d = res["ms_defects"]
  assert d[-1] < 0.05 * max(d[0], 1e-6) + 1e-3, d


def test_sharded_contact_solve_matches_jax(ranks, jax_refs):
  """qp = 4 (one world's rows over 4 ranks) and (dp, qp) = (2, 2) (4 worlds
  over 2, their rows over 2), against JAX's projected Jacobi on meshes of the
  same shapes, on the port's contact problem of tests/test_qp_shard.py's
  sphere-box stack (torch_dist_worker.qp_problems: the same inputs to both
  solvers); the Signorini and cone conditions of
  tests/test_qp_shard.py::test_kkt_conditions on the solution; and the
  padding error of rows that do not divide, in both packages."""
  (G, c0, mu, active), lam4, lam2, pad_error = jax_refs["qp"]
  assert pad_error.startswith("contact row count"), pad_error
  for r in range(N_RANKS):
    res = ranks.result(r)
    np.testing.assert_allclose(res["qp_lam"], lam4, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res["qp2_lam"], lam2, rtol=0, atol=1e-9)
    assert str(res["qp_pad_error"]).split(";")[0] == pad_error.split(";")[0]
  lam = res["qp_lam"]
  v_post = np.einsum("ipjq,jq->ip", G, lam) + c0
  act = active > 0.5
  assert (lam[act, 2] >= -1e-12).all()
  assert (np.linalg.norm(lam[:, :2], axis=1)[act] <= mu[act] * lam[act, 2] + 1e-8).all()
  assert (v_post[act, 2] >= -1e-6).all()
  closed = act & (lam[:, 2] > 1e-8)
  assert closed.any() and np.abs(v_post[closed, 2]).max() < 1e-4
  assert (lam[closed, 2] * v_post[closed, 2] < 1e-6).all()


# ---- the harness, the mesh, the group -------------------------------------------------------


def test_weak_scaling_table(ranks):
  """The table of the sharded iLQR at 1, 2 and 4 ranks: one row a mesh,
  JAX's keys, efficiency 1 at one rank, the same rows on every rank."""
  rows = json.loads(str(ranks.result(0)["scaling_rows"]))
  assert [r["n_devices"] for r in rows] == [1, 2, 4]
  assert set(rows[0]) == {"n_devices", "seconds", "throughput", "per_device", "efficiency",
                          "unit"}
  assert rows[0]["efficiency"] == 1.0 and all(r["unit"] == "solves/s" for r in rows)
  for r in rows:
    assert r["throughput"] > 0 and np.isfinite(r["efficiency"])
  for k in range(1, N_RANKS):
    assert json.loads(str(ranks.result(k)["scaling_rows"])) == rows


def test_init_distributed_from_launcher_variables(ranks):
  """The counterpart of tests/test_distributed.py: the ranks joined one gloo
  group from MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK; make_host_chip_mesh
  grouped them by LOCAL_WORLD_SIZE = 2 into 2 hosts x 2 chips, the chip axis
  inside a host; one all_reduce over the mesh summed every rank's rows."""
  expect = sum(8.0 * (r // 2 + 1) for r in range(N_RANKS))
  for r in range(N_RANKS):
    res = ranks.result(r)
    assert int(res["world"]) == N_RANKS
    assert tuple(res["init_shape"]) == (2, 2)
    assert list(res["init_chip_ranks"]) == [2 * (r // 2), 2 * (r // 2) + 1]
    assert float(res["init_total"]) == expect


def test_one_rank_group_and_placements(ranks):
  """Without launcher variables init_distributed forms a one-rank group of
  its own (a fifth process, launched with the ranks: this process keeps no
  group); shard_batch and gather_batch on it, and the errors."""
  out = ranks.one_rank_output()
  assert "ONE_RANK_OK" in out, out
