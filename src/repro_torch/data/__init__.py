"""Training data of the port: document-length distributions, packing and
the batch pipeline (any CP size, with a background prefetcher)."""
