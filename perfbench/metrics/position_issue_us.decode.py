"""Host us to issue a beam position: the spans `stjep.decode.beam_loop`'
duration less that of the `stjep.decode.flag_read` spans inside them, over
the `stjep.decode.flag_read` spans (one a position)."""

from perfbench import spans

LAYER = "beam loop"
UNIT = "us"
MOVES = "decode_utt_per_s"


def read(r):
    loops, reads = spans.intervals(r, spans.BEAM_LOOP), spans.intervals(r, spans.FLAG_READ)
    if not loops or not reads:
        return None
    issue = spans.total_us(loops) - spans.total_us(spans.intersect(reads, loops))
    return issue / len(reads)
