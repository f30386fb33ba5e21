"""Device idle us a beam position: the idle gaps inside the spans
`stjep.decode.beam_loop`, over the `stjep.decode.flag_read` spans (one
host read of the all-EOS flag a position)."""

from perfbench import spans

LAYER = "beam loop"
UNIT = "us"
MOVES = "decode_utt_per_s"


def read(r):
    loops, reads = spans.intervals(r, spans.BEAM_LOOP), spans.intervals(r, spans.FLAG_READ)
    if not loops or not reads:
        return None
    return spans.idle_us(r, loops) / len(reads)
