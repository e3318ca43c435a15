from parasuite_tpu_torch.parallel.mesh import make_mesh, local_device_count  # noqa: F401
from parasuite_tpu_torch.parallel.dist_align import (  # noqa: F401
    make_dist_align_step,
    shard_batch,
)
