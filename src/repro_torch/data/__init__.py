"""Synthetic data for the port (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import insert_stream, make_clustered, \
    query_stream

__all__ = ["insert_stream", "make_clustered", "query_stream"]
