"""Token corpora for training. Port of ``src/repro/data/``."""
from repro_torch.data.pipeline import (DataConfig, FileShardedCorpus,
                                       SyntheticCorpus)

__all__ = ["DataConfig", "FileShardedCorpus", "SyntheticCorpus"]
