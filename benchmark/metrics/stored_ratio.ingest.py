"""Raw bytes over stored bytes of the units ingested in the window: what the
host matcher's output costs to upload and plan."""


def read(readings):
    c = readings[0]["all_counts"] if readings else {}
    return c["raw_bytes"] / c["stored_bytes"] if c.get("stored_bytes") else None
