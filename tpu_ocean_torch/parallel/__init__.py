"""The distributed runtime: the ('batch', 'shard') mesh over process
ranks, the collectives of the sharded step and the halo ring.

JAX counterpart: ``tpu_ocean/parallel/`` (its GSPMD step,
``make_gspmd_step``, is not ported). The sharded 2-D transform is
``fft/distributed.py``; the solver ``solver_dist.DistributedOceanSolver``.
"""

from tpu_ocean_torch.parallel.mesh import make_mesh, initialize_distributed
from tpu_ocean_torch.parallel.halo import roll_sharded

__all__ = ["make_mesh", "initialize_distributed", "roll_sharded"]
