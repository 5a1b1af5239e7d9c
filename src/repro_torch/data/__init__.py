"""Training data of the port: document-length distributions, packing and
the single-device batch pipeline."""
