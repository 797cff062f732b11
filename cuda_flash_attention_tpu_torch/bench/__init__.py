from cuda_flash_attention_tpu_torch.bench.configs import (  # noqa: F401
    TestConfig,
    create_experiment_configs,
    create_sequence_length_experiment_configs,
    create_test_configs,
)
from cuda_flash_attention_tpu_torch.bench.harness import Harness, TestResult  # noqa: F401
