"""Mean recall@10 of every query answered in the window against its exact
ten nearest points (the benchmark's own brute force, full float32)."""


def read(rec):
    return rec.verdict.recall
