"""Meshes, collectives and the parallel attention forms (counterpart of
cuda_flash_attention_tpu/parallel).  Nothing here runs at import."""

from cuda_flash_attention_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    make_hybrid_mesh,
    scaling_efficiency_bench,
    two_host_serving_mesh,
)
from cuda_flash_attention_tpu_torch.parallel.mesh import make_device_mesh  # noqa: F401
from cuda_flash_attention_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    ring_attention_quantized,
)
from cuda_flash_attention_tpu_torch.parallel.sharded import (  # noqa: F401
    head_parallel_attention,
    shard_qkv,
)
