from defer_tpu_torch.parallel.mesh import (
    describe_topology,
    make_mesh,
    pipeline_devices,
)
from defer_tpu_torch.parallel.pipeline import Pipeline

__all__ = ["Pipeline", "describe_topology", "make_mesh", "pipeline_devices"]
