"""Index structures of the port: distances, exact search, k-means, product
quantization, the SPANN cluster index and the DiskANN graph index."""
