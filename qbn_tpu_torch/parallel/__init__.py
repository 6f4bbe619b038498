"""Multi-device runs (port of qbn_tpu/parallel/): a mesh of processes,
one per device, in a torch.distributed group (mesh.py, `launch`);
data-parallel training and validation steps and the sample-sharded MC
evaluation (sharded.py); vmapped multi-seed training (sweep.py).

As in qbn_tpu, sharding changes placement, never the math: a sharded
step sees the draws, and computes the global-batch quantities, of the
one-process step.
"""

from qbn_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, launch, make_mesh, mesh_from_config, shard_batch)
from qbn_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_eval_step, make_sharded_mc_eval, make_sharded_train_step)
from qbn_tpu_torch.parallel.sweep import (  # noqa: F401
    init_seed_states, init_stacked_metrics, make_vmapped_train_step)
