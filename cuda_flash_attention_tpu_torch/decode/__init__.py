"""Serving layer: paged quantized KV cache, the paged decode (B5) and paged
chunk (B6) kernels, the verify step, continuous-batching engine with
speculative decoding, prefix caching, chunked prefill, logit bias and
penalties, and decode steps (and bursts) as captured CUDA graphs."""

from cuda_flash_attention_tpu_torch.decode.attention import (  # noqa: F401
    paged_chunk_attention,
    paged_chunk_attention_plain,
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
    append_chunk_kv,
    append_token_kv,
    init_kv_pages,
    write_chunk_kv_paged,
    write_prompt_kv,
)
from cuda_flash_attention_tpu_torch.decode.model import (  # noqa: F401
    decode_step,
    prefill_forward,
    verify_step,
)
from cuda_flash_attention_tpu_torch.decode.sampling import (  # noqa: F401
    sample_tokens,
    sample_with_logprob,
    speculative_accept,
    warp_logits,
)
from cuda_flash_attention_tpu_torch.decode.sharded import (  # noqa: F401
    shard_kv_pages,
    tp_chunk_append_attend,
    tp_paged_decode_attention,
)
