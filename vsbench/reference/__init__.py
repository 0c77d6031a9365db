"""The plain reference: the cluster index's lists and search worked out
again from the data and the program's centroids, in plain PyTorch,
importing nothing of the port."""
