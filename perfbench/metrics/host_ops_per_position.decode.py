"""Host aten:: operators a beam position: all the traced batches' host
operators over their beam positions (K3 + K4 launches on the megastep
route, K7 head launches on the general loop: one head a position)."""

LAYER = "beam loop"
UNIT = "ops"
MOVES = "decode_utt_per_s"


def read(r):
    n = r.extra.get("positions")
    return r.host_ops / n if n else None
