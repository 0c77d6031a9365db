"""Index structures of the port: distances, exact search, k-means and the
SPANN cluster index."""
