"""Streaming, out-of-core data plane: chunked sources, mergeable quantile
sketches, and append-extensible party streams.

Entry points:
  * sources — :class:`ChunkedSource` protocol, :class:`ChunkedCSVSource`,
    :class:`ChunkedParquetSource` (needs pyarrow), :class:`ArraySource`,
    :class:`DataProduct` / :class:`ProductSchema`.
  * sketch — :class:`QuantileSketch` / :class:`FeatureSketches` (exact until
    compaction, tracked rank-error bound after).
  * ingest — scan / align / assemble engine; :class:`PartyStream` is the
    session-held append state.

``Federation.ingest`` dispatches here automatically when handed chunked
sources; ``Federation.ingest_append`` lands new product versions.
"""
from repro_torch.streaming.ingest import (PartyStream, SourceScan,
                                          append_streams, assemble_streams,
                                          open_streams, party_stream_bin,
                                          scan_source, streaming_ingest)
from repro_torch.streaming.sketch import (DEFAULT_CAPACITY, FeatureSketches,
                                          QuantileSketch)
from repro_torch.streaming.sources import (DEFAULT_CHUNK_ROWS, ArraySource,
                                           ChunkedCSVSource,
                                           ChunkedParquetSource,
                                           ChunkedSource, DataProduct,
                                           ProductSchema, as_chunked,
                                           is_chunked_sequence)

__all__ = [
    "ArraySource", "ChunkedCSVSource", "ChunkedParquetSource",
    "ChunkedSource", "DataProduct",
    "DEFAULT_CAPACITY", "DEFAULT_CHUNK_ROWS", "FeatureSketches",
    "PartyStream", "ProductSchema", "QuantileSketch", "SourceScan",
    "append_streams", "as_chunked", "assemble_streams", "is_chunked_sequence",
    "open_streams", "party_stream_bin", "scan_source", "streaming_ingest",
]
