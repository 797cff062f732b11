"""Serving layer: paged quantized KV cache, paged decode kernel,
continuous-batching engine."""

from cuda_flash_attention_tpu_torch.decode.attention import (  # noqa: F401
    paged_decode_attention,
    paged_decode_attention_plain,
)
from cuda_flash_attention_tpu_torch.decode.engine import (  # noqa: F401
    DecodeEngine,
    Request,
)
from cuda_flash_attention_tpu_torch.decode.kv_cache import (  # noqa: F401
    KVPages,
    PageAllocator,
    append_token_kv,
    init_kv_pages,
    write_prompt_kv,
)
from cuda_flash_attention_tpu_torch.decode.model import (  # noqa: F401
    decode_step,
    prefill_forward,
)
from cuda_flash_attention_tpu_torch.decode.sampling import (  # noqa: F401
    sample_tokens,
    sample_with_logprob,
    warp_logits,
)
