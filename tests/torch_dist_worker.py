"""One gloo rank of tests/test_torch_parallel.py's run of the port's
parallel layer (raisimlib_torch/parallel) on the CPU.

The test launches 4 of these processes once per module, with the launcher
variables torchrun would set (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE = 2, as two hosts of two ranks), and reads
what each rank writes. Each rank joins the group through
`parallel.init_distributed()` from those variables, counts every
torch.distributed collective that the port's functions issue, runs every
case below, and writes <dir>/rank<r>.npz:

  * init: the host-chip mesh's shape and axes, and one all_reduce over it;
  * the sharded rollout of falling spheres, B = 16, H = 40, at meshes of
    1, 2 and 4 ranks (gathered with gather_batch), and its collectives;
  * the sharded iLQR of the cartpole, B = 16, H = 30, 4 iterations, at 4
    ranks, and its collectives;
  * the sharded MPPI of the cartpole, B = 8, 3 iterations, K = 16, H = 10,
    on the noise that the test drew with JAX (<dir>/mppi_eps.npz);
  * multishoot_solve of the cartpole, H = 64 over 4 segments;
  * the sharded contact solve at qp = 4 and on a (dp, qp) = (2, 2) mesh of
    the problems the test built with qp_problems (<dir>/qp.npz), and the
    error for rows that do not divide;
  * the weak-scaling table of the sharded iLQR at 1, 2 and 4 ranks.

Usage: python tests/torch_dist_worker.py <dir>   (the launcher variables set)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

COUNTED = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce",
           "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "gather", "scatter",
           "send", "recv", "batch_isend_irecv", "barrier")
CALLS = []


def _count(name):
  f = getattr(dist, name)

  def counted(*args, **kwargs):
    CALLS.append(name)
    return f(*args, **kwargs)

  setattr(dist, name, counted)


def cartpole():
  """tests/test_parallel.py's cartpole problem, f64, batched."""
  from raisimlib_torch.models import primitives
  from raisimlib_torch.mpc.smooth import make_smooth_dyn

  model = primitives.cartpole(dtype=torch.float64, device="cpu")
  dyn, nx, nu = make_smooth_dyn(model, (0.0, 0.0, -9.81), dt=0.02, substeps=1)

  def rc(X, U, t):
    return (4.0 * (torch.cos(X[:, 1]) + 1.0) + 0.1 * X[:, 0] ** 2
            + 0.01 * (U ** 2).sum(1)) * 0.02

  def fc(X):
    return 40.0 * (torch.cos(X[:, 1]) + 1.0) + 2.0 * X[:, 0] ** 2 + X[:, 2] ** 2 + X[:, 3] ** 2

  return dyn, nx, nu, rc, fc


def wait_for(path, timeout=180.0):
  """The test writes some inputs after it launches the ranks."""
  t0 = time.time()
  while not os.path.exists(path):
    if time.time() - t0 > timeout:
      raise TimeoutError(path)
    time.sleep(0.05)
  return np.load(path)


def calls_of(fn, *args, **kwargs):
  """fn's result and the collectives it issued."""
  n = len(CALLS)
  out = fn(*args, **kwargs)
  return out, list(CALLS[n:])


def case_init(res):
  from raisimlib_torch import parallel

  m = parallel.make_host_chip_mesh()
  host = m.coordinate("host")
  x = torch.full((2, 4), float(host + 1), dtype=torch.float64).sum()
  dist.all_reduce(x, group=m.group())
  res["init_shape"] = np.array(m.shape)
  res["init_chip_ranks"] = np.array(dist.get_process_group_ranks(m.group("chip")))
  res["init_total"] = x.numpy()


def case_rollout(res):
  from raisimlib_torch import parallel
  from raisimlib_torch.ops.integrator import State
  from raisimlib_torch.world import World

  world = World(dt=0.002, dtype=torch.float64, device="cpu")
  world.add_sphere(0.1, 1.0, pos=(0.0, 0.0, 0.3))
  world.add_ground()
  scene = world.compile()
  B, H = 16, 40
  q0 = scene.model.q_init[None].repeat(B, 1)
  q0[:, 2] = torch.linspace(0.15, 0.5, B, dtype=torch.float64)
  s0 = State(q=q0, u=torch.zeros((B, scene.model.nv), dtype=torch.float64),
             t=torch.zeros(B, dtype=torch.float64))
  taus = torch.zeros((B, H, scene.model.nv), dtype=torch.float64)
  for n in (1, 2, 4):
    mesh = parallel.make_mesh(n)
    if not mesh.contains():
      continue
    rollout = parallel.make_sharded_rollout(scene, mesh)
    (final, qs), calls = calls_of(rollout, *parallel.shard_batch(mesh, (s0, taus)))
    q_all, qs_all = parallel.gather_batch(mesh, (final.q, qs))
    res[f"rollout{n}_q"], res[f"rollout{n}_qs"] = q_all.numpy(), qs_all.numpy()
    res[f"rollout{n}_calls"] = np.array(calls, dtype=str)
    res[f"rollout{n}_fused"] = np.array(rollout.fused)


def case_ilqr(res, mesh, dyn, nx, nu, rc, fc):
  from raisimlib_torch import parallel
  from raisimlib_torch.mpc.ilqr import ILQRConfig

  B, H = 16, 30
  x0s = torch.zeros((B, nx), dtype=torch.float64)
  x0s[:, 0] = torch.linspace(-0.5, 0.5, B, dtype=torch.float64)
  U0s = torch.zeros((B, H, nu), dtype=torch.float64)
  solve = parallel.make_sharded_ilqr(dyn, rc, fc, mesh, ILQRConfig(iters=4))
  (U, cost, metrics), calls = calls_of(solve, *parallel.shard_batch(mesh, (x0s, U0s)))
  U, cost = parallel.gather_batch(mesh, (U, cost))
  res.update(ilqr_U=U.numpy(), ilqr_cost=cost.numpy(), ilqr_calls=np.array(calls, dtype=str),
             ilqr_mean=metrics["mean_cost"].numpy(), ilqr_max=metrics["max_cost"].numpy())


def case_mppi(res, mesh, dyn, nx, nu, rc, fc, eps):
  from raisimlib_torch import parallel
  from raisimlib_torch.mpc.mppi import MPPIConfig

  B, n_iters, K, H = eps.shape[:4]
  x0s = torch.zeros((B, nx), dtype=torch.float64)
  x0s[:, 1] = torch.linspace(0.2, 0.6, B, dtype=torch.float64)
  U0s = torch.zeros((B, H, nu), dtype=torch.float64)
  solve = parallel.make_sharded_mppi(dyn, rc, fc, mesh, n_iters,
                                     MPPIConfig(n_samples=K, sigma=0.5))
  x_l, U_l, e_l = parallel.shard_batch(mesh, (x0s, U0s, torch.as_tensor(eps)))
  (U, cost, mean_cost), calls = calls_of(solve, x_l, U_l, eps_white=e_l)
  U, cost = parallel.gather_batch(mesh, (U, cost))
  res.update(mppi_U=U.numpy(), mppi_cost=cost.numpy(), mppi_mean=mean_cost.numpy(),
             mppi_calls=np.array(calls, dtype=str))


def case_multishoot(res, mesh, dyn, nx, nu, rc, fc):
  from raisimlib_torch.mpc.ilqr import ILQRConfig
  from raisimlib_torch.parallel import MultiShootConfig, multishoot_solve

  x0 = torch.zeros(nx, dtype=torch.float64)
  x0[1] = 0.3
  U0 = torch.zeros((64, nu), dtype=torch.float64)
  cfg = MultiShootConfig(outer_iters=8, ilqr=ILQRConfig(iters=6), rho=20.0)
  sol, calls = calls_of(multishoot_solve, dyn, rc, fc, x0, U0, mesh, cfg)
  res.update(ms_U=sol.U.numpy(), ms_knots=sol.knots.numpy(), ms_cost=sol.cost.numpy(),
             ms_defects=sol.defect_trace.numpy(), ms_calls=np.array(calls, dtype=str))


def _pad_rows(G, c0, mu, active, n_pad):
  """tests/test_qp_shard.py's padding: inactive rows, identity diagonal."""
  nc = c0.shape[0]
  m = nc + n_pad
  Gp = np.zeros((m, 3, m, 3))
  Gp[:nc, :, :nc, :] = G
  for k in range(nc, m):
    Gp[k, :, k, :] = np.eye(3)
  z = np.zeros(n_pad)
  return Gp, np.concatenate([c0, np.zeros((n_pad, 3))]), np.r_[mu, z], np.r_[active, z]


def contact_problem(settle=10):
  """tests/test_qp_shard.py's contact problem in the port: its sphere-box
  stack, here placed 0.1 mm into contact (box on the ground, sphere on the
  box) so that a few reference steps settle it where tests/test_qp_shard.py
  takes 150 from a drop, the sphere pushed at 0.3 m/s; the solver inputs
  (G, c0, mu, active) of the next step, f64 numpy: the box's 8 corners on
  the ground (a statically indeterminate manifold) and the sliding sphere."""
  from raisimlib_torch.ops import pipeline
  from raisimlib_torch.ops.integrator import State
  from raisimlib_torch.world import World

  world = World(dt=0.002, dtype=torch.float64, device="cpu")
  world.add_ground()
  world.add_box((0.25, 0.25, 0.15), mass=2.0, pos=(0.0, 0.0, 0.1499))
  world.add_sphere(0.12, mass=1.0, pos=(0.05, 0.0, 0.4198))
  scene = world.compile()
  s = scene.init_state()
  s.u[9] = 0.3
  s = State(q=s.q[None], u=s.u[None], t=s.t[None])
  tau = torch.zeros((1, scene.model.nv), dtype=torch.float64)
  with torch.no_grad():
    for _ in range(settle):
      s = pipeline.step(scene, s, tau)
    (G, c0, mu, active), _ = pipeline._pre_solve(scene, s, tau)
  return tuple(a[0].numpy() for a in (G, c0, mu, active))


def qp_problems():
  """contact_problem padded to 4 rows a rank, and its 2-D batch: 4 worlds,
  the free velocity shifted by 1e-3 b, rows padded to 2 a rank (as
  tests/test_qp_shard.py builds its problems)."""
  G, c0, mu, active = contact_problem()
  nc = c0.shape[0]
  p4 = _pad_rows(G, c0, mu, active, (-nc) % 4)
  G2, c2, mu2, a2 = _pad_rows(G, c0, mu, active, (-nc) % 2)
  B = 4
  p2 = (np.broadcast_to(G2, (B,) + G2.shape).copy(),
        c2[None] + 1e-3 * np.arange(B)[:, None, None], np.tile(mu2, (B, 1)),
        np.tile(a2, (B, 1)))
  return p4, p2


def case_qp(res, qp):
  from raisimlib_torch.parallel import Mesh
  from raisimlib_torch.parallel.qp_shard import make_sharded_contact_solver

  t4, t2 = ([torch.as_tensor(qp[f"{tag}_{k}"]) for k in ("G", "c0", "mu", "active")]
            for tag in ("qp", "qp2"))
  solver = make_sharded_contact_solver(Mesh(np.arange(4), ("qp",)), qp_axis="qp",
                                       dp_axis=None, iters=128, omega=0.7)
  res["qp_lam"] = solver(*t4).numpy()
  try:
    solver(t4[0][:-1, :, :-1], t4[1][:-1], t4[2][:-1], t4[3][:-1])
    res["qp_pad_error"] = np.array("")
  except ValueError as e:
    res["qp_pad_error"] = np.array(str(e))
  solver2 = make_sharded_contact_solver(Mesh(np.arange(4).reshape(2, 2), ("dp", "qp")),
                                        qp_axis="qp", dp_axis="dp", iters=128, omega=0.7)
  res["qp2_lam"] = solver2(*t2).numpy()


def case_scaling(res, dyn, nx, nu, rc, fc):
  from raisimlib_torch import parallel
  from raisimlib_torch.mpc.ilqr import ILQRConfig

  per_dev, H = 2, 10

  def build(mesh):
    B = per_dev * mesh.size
    x0s = torch.zeros((B, nx), dtype=torch.float64)
    U0s = torch.zeros((B, H, nu), dtype=torch.float64)
    solve = parallel.make_sharded_ilqr(dyn, rc, fc, mesh, ILQRConfig(iters=2))
    return solve, parallel.shard_batch(mesh, (x0s, U0s))

  rows = parallel.weak_scaling_report(build, per_dev, device_counts=[1, 2, 4], repeats=1,
                                      unit="solves/s")
  res["scaling_rows"] = np.array(json.dumps(rows))


def main():
  out_dir = sys.argv[1]
  torch.set_num_threads(1)
  from raisimlib_torch import parallel

  dev = parallel.init_distributed(device="cpu")
  assert dev.type == "cpu" and dist.get_backend() == "gloo", (dev, dist.get_backend())
  for name in COUNTED:
    _count(name)
  res = {"world": np.array(dist.get_world_size())}
  case_init(res)
  case_rollout(res)
  prob = cartpole()
  mesh4 = parallel.make_mesh(4)
  case_ilqr(res, mesh4, *prob)
  case_mppi(res, mesh4, *prob, wait_for(os.path.join(out_dir, "mppi_eps.npz"))["eps"])
  case_multishoot(res, mesh4, *prob)
  case_qp(res, wait_for(os.path.join(out_dir, "qp.npz")))
  case_scaling(res, *prob)
  rank = dist.get_rank()
  np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
  dist.destroy_process_group()
  print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
  main()
