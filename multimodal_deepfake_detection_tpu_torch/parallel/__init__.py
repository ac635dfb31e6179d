"""Multi-device runs (counterpart of ``multimodal_deepfake_detection_tpu/parallel/``)."""
from .distributed import hybrid_mesh
from .distributed import initialize as distributed_initialize
from .mesh import auto_data_mesh, data_sharding, local_devices, make_mesh, replicate, shard_batch
