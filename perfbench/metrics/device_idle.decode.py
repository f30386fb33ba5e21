"""The card's idle share over the traced decode batches: 1 - (the union of
the device operations' intervals) / (the stretch's wall time)."""

LAYER = "device"
UNIT = "%"
MOVES = "decode_utt_per_s"


def read(r):
    s = r.idle_share()
    return None if s is None else 100.0 * s
