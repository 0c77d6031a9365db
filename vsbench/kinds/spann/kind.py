"""The SPANN cluster index (``repro_torch.core.cluster_index``): a request
probes ``nprobe`` lists; the lists themselves are held to the closure rule
(``lists_differ``)."""

KNOBS = ("nprobe",)
NUMBERS = ("lists_differ",)
PARAMS = ("centroid_frac", "num_replica", "closure_eps", "kmeans_iters",
          "branch", "balance_penalty")


def params(cfg: dict) -> dict:
    """``ClusterIndexParams``' fields as a configuration file states them."""
    return {**{key: cfg[key] for key in PARAMS}, "seed": cfg["index_seed"]}
