"""Config registry: the retrieval serving presets."""
from repro_torch.configs.retrieval import (  # noqa: F401
    RETRIEVAL_CONFIGS,
    RetrievalConfig,
    get_retrieval_config,
)
