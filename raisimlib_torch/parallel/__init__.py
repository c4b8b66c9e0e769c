"""Parallelism over torch.distributed ranks: the port's counterpart of
raisimlib_tpu/parallel/.

Data parallelism shards the scenario and rollout batch over a mesh of ranks
(sharded.py); the multiple-shooting time decomposition splits the horizon
over ranks (multishoot.py); the contact QP's rows split over ranks
(qp_shard.py); scaling.py is the weak-scaling harness. One process per
device (mesh.py)."""

from raisimlib_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_batch,
    init_distributed,
    make_host_chip_mesh,
    make_mesh,
    shard_batch,
)
from raisimlib_torch.parallel.multishoot import (  # noqa: F401
    MultiShootConfig,
    MultiShootSolution,
    multishoot_solve,
)
from raisimlib_torch.parallel.scaling import time_workload, weak_scaling_report  # noqa: F401
from raisimlib_torch.parallel.sharded import (  # noqa: F401
    make_sharded_ilqr,
    make_sharded_mppi,
    make_sharded_rollout,
)
