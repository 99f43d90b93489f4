from defer_tpu_torch.parallel.mesh import pipeline_devices
from defer_tpu_torch.parallel.pipeline import Pipeline

__all__ = ["Pipeline", "pipeline_devices"]
