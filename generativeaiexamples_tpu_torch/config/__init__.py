from .schema import (
    AppConfig,
    EmbeddingConfig,
    EngineConfig,
    LLMConfig,
    MeshConfig,
    PromptsConfig,
    RerankerConfig,
    RetrieverConfig,
    TextSplitterConfig,
    TracingConfig,
    VectorStoreConfig,
    VoiceConfig,
)
from .wizard import (
    config_from_env, get_config, load_config, print_config_help, set_config)

__all__ = [
    "AppConfig",
    "EmbeddingConfig",
    "EngineConfig",
    "LLMConfig",
    "MeshConfig",
    "PromptsConfig",
    "RerankerConfig",
    "RetrieverConfig",
    "TextSplitterConfig",
    "TracingConfig",
    "VectorStoreConfig",
    "VoiceConfig",
    "config_from_env",
    "get_config",
    "load_config",
    "print_config_help",
    "set_config",
]
