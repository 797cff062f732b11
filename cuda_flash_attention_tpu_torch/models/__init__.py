from cuda_flash_attention_tpu_torch.models.training import (  # noqa: F401
    Optimizer,
    TrainState,
    init_train_state,
    make_optax_train_step,
    make_optimizer,
    train_loop,
)
from cuda_flash_attention_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    ffn_block,
    forward,
    gqa_flash_attention,
    init_opt_state,
    init_params,
    loss_fn,
    make_train_step,
    rms_norm,
    rope,
)
