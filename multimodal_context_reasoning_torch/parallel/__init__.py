"""Data and tensor parallelism over ``torch.distributed`` (port of the JAX
package's ``parallel/``).

The JAX package runs one SPMD program over a ``("data", "model")`` device
mesh and lets XLA place the collectives.  The port runs one process per
device: ``mesh.py`` builds the same mesh as a ``DeviceMesh`` over the
process group, ``partition.py`` splits the model's heads and FFN neurons
over the ``model`` axis and each batch over ``data``, ``comm.py`` holds the
collectives (all-reduce and broadcast only), and ``multihost.py`` checks
that every rank holds the same device-resident feature table.  The train
step averages gradients over ``data`` itself (train/step.py): DDP's reducer
does not see gradients taken with ``torch.autograd.grad``.
"""

from multimodal_context_reasoning_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    mesh_shape_for,
)
from multimodal_context_reasoning_torch.parallel.multihost import (  # noqa: F401
    check_replicated,
)
from multimodal_context_reasoning_torch.parallel.partition import (  # noqa: F401
    PARAM_RULES,
    gather_state_dict,
    local_rows,
    shard_module_,
    shard_state_dict,
)
