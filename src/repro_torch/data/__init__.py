"""Synthetic data for the port (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import make_clustered, query_stream

__all__ = ["make_clustered", "query_stream"]
