"""Full physics step on a batch of worlds: collision -> contact solve -> integrate.

Counterpart of raisimlib_tpu/ops/pipeline.py:

    kin      = fk(q, u)
    contacts = collide(geoms, pairs, kin)          # padded, masked
    v_free   = u + dt M^-1 (tau - h)               # semi-implicit free velocity
    lam      = per-contact cone Gauss-Seidel solve
    u'       = v_free + M^-1 J^T lam
    q'       = q (+) u' dt

Every function here takes a leading batch dimension B of worlds (the JAX
package's single-world functions under `vmap`). Restitution and Baumgarte
stabilisation enter as a normal-velocity bias. On a scene with a heightmap,
`field_heights` (B, nx, ny) gives each world its own terrain heights (the JAX
package's `scene.replace(field=...)` under `vmap`); None uses the scene's
field for every world. `f_ext_w` (B, nb, 6) are external wrenches, world
frame at the world origin ([torque, force], spatial.force_at_point); they
and the compliant wires' forces enter the bias term through RNEA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raisimlib_torch.models.model import JointType
from raisimlib_torch.ops import collision as coll
from raisimlib_torch.ops import constraints as cs
from raisimlib_torch.ops import contact as ct
from raisimlib_torch.ops import dynamics, gpu_contact, linalg
from raisimlib_torch.ops.integrator import State


@dataclasses.dataclass(frozen=True)
class StepConfig:
  erp: float = 0.2               # Baumgarte position-error velocity gain (per step)
  slop: float = 1e-4             # penetration tolerance before correction kicks in
  max_correction_vel: float = 1.0
  solver: ct.SolverConfig = ct.SolverConfig()


def contact_jacobians(model, kin, contacts: coll.ContactSet):
  """(B, nc, 3, nv) world-frame relative-velocity Jacobians v_rel = J u =
  v(A) - v(B): per-dof columns lin_j + ang_j x p weighted by the static
  ancestor-mask difference mask_A - mask_B."""
  nc = len(contacts.body_a)
  amask = dynamics.ancestor_dof_mask(model)
  mdiff = np.zeros((nc, model.nv))
  for k in range(nc):
    if contacts.body_a[k] >= 0:
      mdiff[k] += amask[contacts.body_a[k]]
    if contacts.body_b[k] >= 0:
      mdiff[k] -= amask[contacts.body_b[k]]
  pos = contacts.pos
  mdiff = torch.as_tensor(mdiff, dtype=pos.dtype, device=pos.device)
  ang, lin = kin.S_w[:, None, :, :3], kin.S_w[:, None, :, 3:]     # (B,1,nv,3)
  cols = lin + torch.linalg.cross(ang.expand(-1, nc, -1, -1),
                                  pos[:, :, None, :].expand(-1, -1, model.nv, -1))
  return (cols * mdiff[:, :, None]).transpose(-1, -2)


def _tangent_frames(normals):
  """(..., 3) unit normals -> (..., 3, 3) frames with rows (t1, t2, n), by the
  branch-free least-aligned-axis pick."""
  n = normals
  ax = n.abs()
  eye = torch.eye(3, dtype=n.dtype, device=n.device)
  pick_x = (ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2])
  pick_y = ~pick_x & (ax[..., 1] <= ax[..., 2])
  a = torch.where(pick_x[..., None], eye[0], torch.where(pick_y[..., None], eye[1], eye[2]))
  t1 = torch.linalg.cross(n, a)
  t1 = t1 / torch.sqrt(torch.sum(t1 * t1, -1, keepdim=True) + 1e-18)
  t2 = torch.linalg.cross(n, t1)
  return torch.stack([t1, t2, n], -2)


def _joint_pos_index(model):
  """Static (nv,) map dof -> q index for 1-dof joints, and its 0/1 mask."""
  idx = np.zeros(model.nv, dtype=np.int64)
  mask = np.zeros(model.nv)
  for i in range(model.nb):
    if JointType(model.joint_types[i]) in (JointType.REVOLUTE, JointType.PRISMATIC):
      idx[model.v_adr[i]] = model.q_adr[i]
      mask[model.v_adr[i]] = 1.0
  return idx, mask


def _mv(A, x):
  return (A @ x.unsqueeze(-1)).squeeze(-1)


def scene_field(scene, field_heights=None, device=None):
  """The scene's heightfield, with per-world heights (B, nx, ny) swapped in
  when given; None for a scene without one. Raises for heights that a scene
  without a field, or of another grid or device, is given."""
  field = getattr(scene, "field", None)
  if field_heights is None:
    return field
  if field is None:
    raise ValueError("field_heights given for a scene without a heightmap")
  if field_heights.ndim != 3 or tuple(field_heights.shape[1:]) != field.shape:
    raise ValueError(f"field_heights has shape {tuple(field_heights.shape)}, expected "
                     f"(B, {field.shape[0]}, {field.shape[1]})")
  if device is not None and field_heights.device != device:
    raise ValueError(f"field_heights is on {field_heights.device}, the state on {device}")
  return field.replace(heights=field_heights)


def _assemble_rows(scene, state: State, tau, pd_target=None,
                   config: StepConfig = StepConfig(), field_heights=None, f_ext_w=None):
  """Collision -> solver-row assembly, shared by the step paths.

  Returns (Jr, bias, mu, active, M, rhs0):
    Jr   (B, n_rows, 3, nv) row Jacobians, already in contact frames
    bias (B, n_rows, 3) desired post-velocity bias (restitution + Baumgarte)
    M    (B, nv, nv) mass matrix incl. the implicit-PD dt*diag(kd) term
    rhs0 (B, nv) tau - h - D u  (so v_free = u + dt M^-1 rhs0)"""
  model, dt = scene.model, scene.dt
  q, u = state.q, state.u
  dtype, dev = q.dtype, q.device
  B = q.shape[0]

  tau = tau * model.actuated
  D = torch.zeros(model.nv, dtype=dtype, device=dev)
  if pd_target is not None:
    jidx, jmask = _joint_pos_index(model)
    jm = torch.as_tensor(jmask, dtype=dtype, device=dev)
    joint_q = q[:, torch.as_tensor(jidx, device=dev)] * jm
    tau = tau + scene.kp * (pd_target - joint_q) * model.actuated * jm
    D = scene.kd * model.actuated
  tau = torch.minimum(torch.maximum(tau, -model.torque_limit), model.torque_limit)

  kin = dynamics.fk(model, q, u)
  contacts = coll.collide(scene.geoms, scene.pairs, kin,
                          scene_field(scene, field_heights, dev))
  tabs = scene.constraints or cs.EMPTY
  M = dynamics.crba_w(model, q, kin) + dt * torch.diag(D)
  f_ext = cs.compliant_forces(model, tabs, kin, u) if tabs.compliant else None
  if f_ext_w is not None:                 # user wrenches (setExternalForce)
    f_ext = f_ext_w if f_ext is None else f_ext + f_ext_w
  h = dynamics.nonlinearities(model, q, u, scene.gravity, f_ext)

  Jc = contact_jacobians(model, kin, contacts)              # (B, nc, 3, nv)
  C = _tangent_frames(contacts.normal)                      # (B, nc, 3, 3)
  mats = scene.materials
  pair_props = mats[torch.as_tensor(contacts.mat_a, device=dev),
                    torch.as_tensor(contacts.mat_b, device=dev)]
  mu = pair_props[:, 0].expand(B, -1)
  e, thresh = pair_props[:, 1], pair_props[:, 2]
  Jr = C @ Jc                                               # rows -> (t1, t2, n)
  vn_pre = _mv(Jr, u[:, None, :])[..., 2]                   # pre-impact normal velocity
  b_rest = torch.where(vn_pre < -thresh, -e * vn_pre, torch.zeros_like(vn_pre))
  b_baum = torch.clamp(config.erp * torch.clamp(contacts.depth - config.slop, min=0.0) / dt,
                       max=config.max_correction_vel)
  b = torch.maximum(b_rest, b_baum)
  zeros = torch.zeros_like(b)
  bias = torch.stack([zeros, zeros, b], -1)
  active = contacts.active

  if tabs.n_rows:
    Jx, bx, mux, actx = cs.constraint_rows(model, tabs, kin, q, u, dt, config.erp,
                                           config.max_correction_vel)
    Jr = torch.cat([Jr, Jx], 1)
    bias = torch.cat([bias, bx], 1)
    mu = torch.cat([mu, mux], 1)
    active = torch.cat([active, actx], 1)
  return Jr, bias, mu, active, M, tau - h - D * u


def _pre_solve(scene, state: State, tau, pd_target=None,
               config: StepConfig = StepConfig(), field_heights=None, f_ext_w=None):
  """Everything up to the contact solve, with the Delassus G formed by one
  fused (1 + 3 n_rows)-column cho_solve: the reference step's path."""
  nv, dt = scene.model.nv, scene.dt
  Jr, bias, mu, active, M, rhs0 = _assemble_rows(scene, state, tau, pd_target, config,
                                                 field_heights, f_ext_w)
  B, nr = Jr.shape[:2]
  L = linalg.chol(M)
  Jf = Jr.reshape(B, nr * 3, nv)
  sol = linalg.cho_solve(L, torch.cat([rhs0[..., None], Jf.transpose(-1, -2)], -1))
  v_free = state.u + dt * sol[..., 0]
  MinvJT = sol[..., 1:]                                     # (B, nv, 3 nr)
  G = (Jf @ MinvJT).reshape(B, nr, 3, nr, 3)
  c0 = _mv(Jr, v_free[:, None, :]) - bias
  return (G, c0, mu, active), (MinvJT, v_free)


def scene_row_kinds(scene) -> tuple:
  """Static kind per solver row: contacts first, then constraint rows."""
  nc = max(coll.num_contact_slots(scene.geoms, scene.pairs), 1)
  tabs = scene.constraints or cs.EMPTY
  return ("cone",) * nc + tabs.row_kinds


def _post_solve(scene, state: State, ctx, lam) -> State:
  """Apply contact-frame impulses and integrate positions."""
  MinvJT, v_free = ctx
  u_new = v_free + _mv(MinvJT, lam.reshape(lam.shape[0], -1))
  q_new = dynamics.integrate_q(scene.model, state.q, u_new, scene.dt)
  return State(q=q_new, u=u_new, t=state.t + scene.dt)


def step(scene, state: State, tau, pd_target=None,
         config: StepConfig = StepConfig(), field_heights=None, f_ext_w=None) -> State:
  """Reference step: forms G and runs the Gauss-Seidel cone solve."""
  solver_in, ctx = _pre_solve(scene, state, tau, pd_target, config, field_heights, f_ext_w)
  G, c0, mu, active = solver_in
  lam = ct.solve_contacts(G, c0, mu, active, config=config.solver)
  return _post_solve(scene, state, ctx, lam)


def step_with_report(scene, state: State, tau, pd_target=None,
                     config: StepConfig = StepConfig(), field_heights=None):
  """`step`, and what it solved (RaiSim's `getContacts()` / `getImpulse()`):
  returns (new_state, contacts, lam_loc, lam_world), the ContactSet of the
  entering state and the impulses (B, n_rows, 3) in the contact frames
  (t1, t2, n) and in the world frame (constraint rows keep their own
  frame). Slower than `step`: the collision runs twice."""
  solver_in, ctx = _pre_solve(scene, state, tau, pd_target, config, field_heights)
  G, c0, mu, active = solver_in
  lam_loc = ct.solve_contacts(G, c0, mu, active, config=config.solver)
  new_state = _post_solve(scene, state, ctx, lam_loc)
  # the contact frames again: the step keeps only the rotated rows
  kin = dynamics.fk(scene.model, state.q, state.u)
  contacts = coll.collide(scene.geoms, scene.pairs, kin,
                          scene_field(scene, field_heights, state.q.device))
  ncc = contacts.depth.shape[1]
  C = _tangent_frames(contacts.normal)                      # (B, ncc, 3, 3)
  lam_world = lam_loc.clone()
  lam_world[:, :ncc] = (C.transpose(-1, -2) @ lam_loc[:, :ncc, :, None])[..., 0]
  return new_state, contacts, lam_loc, lam_world


def solver_inputs(scene, state: State, tau, pd_target=None,
                  config: StepConfig = StepConfig(), field_heights=None, f_ext_w=None):
  """The factors the batched solve consumes, and its config with the row kinds.

  Returns ((Jr, Wt, vf, bias, mu, active), solver_config): Wt = J M^-1 is
  applied as (invL^T)(invL .) with L the Cholesky factor of M, and
  vf = u + dt M^-1 rhs0 is the free velocity."""
  model, dt = scene.model, scene.dt
  nv = model.nv
  Jr, bias, mu, active, M, rhs0 = _assemble_rows(scene, state, tau, pd_target, config,
                                                 field_heights, f_ext_w)
  L = linalg.chol(M)
  invL = linalg.solve_lower(L, torch.eye(nv, dtype=M.dtype, device=M.device))
  invLt = invL.transpose(-1, -2)
  B, nr = Jr.shape[:2]
  Wt = ((Jr.reshape(B, nr * 3, nv) @ invLt) @ invL).reshape(Jr.shape)  # rows of J M^-1
  vf = state.u + dt * _mv(invLt, _mv(invL, rhs0))

  kinds = scene_row_kinds(scene)
  tabs = scene.constraints or cs.EMPTY
  n_con = nr - tabs.n_rows
  if n_con < 0 or kinds != ("cone",) * n_con + tabs.row_kinds:
    raise AssertionError(f"solver row sections out of sync: {nr} assembled rows "
                         f"({n_con} contacts + {tabs.n_rows} constraints) vs kinds {kinds}")
  return (Jr, Wt, vf, bias, mu, active), dataclasses.replace(config.solver, row_kinds=kinds)


def step_batch(scene, state: State, tau, pd_target=None,
               config: StepConfig = StepConfig(), field_heights=None,
               use_kernel: bool = True, f_ext_w=None) -> State:
  """Batched step without forming G: the solve consumes J and J M^-1.

  `use_kernel=True` runs ops/gpu_contact.solve_dynamics_batch (the CUDA
  kernel on the card, its plain twin on the CPU); `use_kernel=False` runs the
  differentiable reference `_mf_pure`."""
  args, solver_cfg = solver_inputs(scene, state, tau, pd_target, config, field_heights,
                                   f_ext_w)
  solve = gpu_contact.solve_dynamics_batch if use_kernel else gpu_contact._mf_pure
  u_new, _ = solve(*args, solver_cfg)
  q_new = dynamics.integrate_q(scene.model, state.q, u_new, scene.dt)
  return State(q=q_new, u=u_new, t=state.t + scene.dt)
