"""Synthetic data for the port (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import TokenStream, insert_stream, \
    make_clustered, query_stream

__all__ = ["TokenStream", "insert_stream", "make_clustered", "query_stream"]
