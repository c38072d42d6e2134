"""Data parallelism over GPUs with `torch.distributed`, and the mesh's
'model' axis as sharded storage: the port of the JAX package's
`parallel/` (`mesh.py`, `distributed.py`; `model_axis.py` for its
parameter and optimizer shardings)."""
from forwardtacotron_tpu_torch.parallel.distributed import (  # noqa: F401
    is_main_process, local_batch, local_device, local_rows, maybe_initialize,
    process_slice, training_device, wait_for_all)
from forwardtacotron_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, active_mesh, broadcast_state, data_parallel, global_sum, make_mesh,
    mesh_from_config, param_spec, param_specs, reduce_gradients,
    reduce_metrics, sum_over_ranks)
