"""Serving example: continuous batching over a paged quantized KV cache
with the sampling and serving API (the port's counterpart of the
repository's examples/serve.py).

    python -m cuda_flash_attention_tpu_torch.examples.serve               # the card
    python -m cuda_flash_attention_tpu_torch.examples.serve --device cpu  # plain versions
"""

from __future__ import annotations

import argparse

import torch

from cuda_flash_attention_tpu_torch.decode import DecodeEngine
from cuda_flash_attention_tpu_torch.models import TransformerConfig, init_params


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    # Toy model; for real weights, utils.hf_convert.load_llama(model) gives
    # (params, cfg) from a transformers Llama model.
    cfg = TransformerConfig(vocab_size=2048, d_model=256, n_layers=4, n_heads=8,
                            n_kv_heads=4, head_dim=32, d_ff=512)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=args.device)

    eng = DecodeEngine(
        params, cfg,
        max_seqs=4,                 # concurrent sequences
        max_seq_len=1024,
        cache_dtype=torch.int8,     # paged INT8 KV cache
        temperature=0.8, top_p=0.95, min_p=0.02,
        logprobs=True,
        prefill_chunk=256,          # long prompts advance chunk by chunk
        prefix_cache=True,          # shared prompt prefixes stored once
        decode_burst=8,             # up to 8 chained steps per readback
        device=args.device,
    )

    system_prompt = list(range(1, 257))  # stands in for a shared system prompt
    requests = eng.submit_many(
        [system_prompt + [300 + i] for i in range(4)],
        max_new_tokens=24,
        stop=[[0]],                         # stop sequence (token ids)
        logit_bias={1999: float("-inf")},   # ban a token
        presence_penalty=0.2,
        on_token=lambda t: None,            # streaming hook
    )
    while any(not r.done for r in requests):
        eng.step()
    eng.step()  # final retire

    for r in requests:
        print(f"req {r.uid}: {len(r.generated)} tokens, "
              f"first logprobs {[round(x, 2) for x in r.logprobs[:4]]}")
    print("engine stats:", eng.stats)
    return requests, eng


if __name__ == "__main__":
    main()
