"""Device idle ms a decode request outside its beam: the idle gaps inside
the spans `stjep.decode` and outside `stjep.decode.beam_loop` (the inputs'
copies, the LAS pass, the encoder, the caches' set-up, the best beam's
slice), over the `stjep.decode` spans."""

from perfbench import spans

LAYER = "decode entry"
UNIT = "ms"
MOVES = "decode_utt_per_s"


def read(r):
    calls = spans.intervals(r, spans.DECODE)
    if not calls:
        return None
    return spans.idle_us(r, calls, spans.intervals(r, spans.BEAM_LOOP)) / 1e3 / len(calls)
