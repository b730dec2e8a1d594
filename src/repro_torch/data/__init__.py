from repro_torch.data.pipeline import SyntheticTokenSource, TokenDatasetSpec

__all__ = ["SyntheticTokenSource", "TokenDatasetSpec"]
