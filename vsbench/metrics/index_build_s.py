"""Host clock around ``ClusterIndex.build`` (host BKT, closure on the card),
``device_arrays`` and the copy to the card, ending in a synchronize."""


def read(rec):
    return rec.spans.get("index_build_s")
