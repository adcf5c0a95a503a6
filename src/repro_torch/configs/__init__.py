from repro_torch.configs.base import (  # noqa: F401
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    ServeConfig,
    ShardConfig,
    WalkConfig,
    WindowConfig,
)
