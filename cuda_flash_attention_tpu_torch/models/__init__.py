from cuda_flash_attention_tpu_torch.models.lora import (  # noqa: F401
    LoRATensor,
    apply_lora,
    lora_trainable_mask,
    merge_lora,
)
from cuda_flash_attention_tpu_torch.models.moe import (  # noqa: F401
    init_moe_layer,
    moe_ffn,
    moe_layer_shardings,
)
from cuda_flash_attention_tpu_torch.models.pipeline import (  # noqa: F401
    make_pp_loss_fn,
    make_pp_train_step,
    pipeline_param_shardings,
    stack_pipeline_params,
)
from cuda_flash_attention_tpu_torch.models.training import (  # noqa: F401
    LoRAOptimizer,
    Optimizer,
    TrainState,
    init_train_state,
    make_lora_optimizer,
    make_optax_train_step,
    make_optimizer,
    train_loop,
)
from cuda_flash_attention_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    ffn_block,
    forward,
    gather_params,
    gqa_flash_attention,
    init_opt_state,
    init_params,
    loss_fn,
    make_train_step,
    param_split_dims,
    rms_norm,
    rope,
    shard_params,
)
