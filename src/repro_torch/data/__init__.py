from repro_torch.data.calorimeter import (CalorimeterSource, CalorimeterSpec,
                                          generate_batch)
from repro_torch.data.pipeline import SyntheticTokenSource, TokenDatasetSpec
from repro_torch.data.shards import ShardedDataset, write_dataset

__all__ = ["CalorimeterSource", "CalorimeterSpec", "ShardedDataset",
           "SyntheticTokenSource", "TokenDatasetSpec", "generate_batch",
           "write_dataset"]
