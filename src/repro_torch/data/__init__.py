"""repro_torch.data — deterministic LM data streams (numpy), as in the JAX package."""

from repro_torch.data.pipeline import (
    DataConfig,
    Prefetcher,
    SyntheticLM,
    TokenFileDataset,
    make_dataset,
    pack_documents,
)
