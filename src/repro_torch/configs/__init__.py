from repro_torch.configs.base import (  # noqa: F401
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    ShardConfig,
    WalkConfig,
    WindowConfig,
)
