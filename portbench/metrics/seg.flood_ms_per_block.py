"""Host milliseconds a block of the device flood (device ops): the seconds
of the window's `watershed.flood` spans over their `blocks` (the minimax
engine's sweep and re-labeling blocks, or the level engine's claim
rounds)."""

from portbench import spans


def read(rec):
    floods = spans.named(rec, "mesmer.segment_fovs", "watershed.flood")
    blocks = sum(s["attrs"].get("blocks", 0) for s in floods)
    if not floods or not blocks:
        return None
    return 1e3 * sum(spans.seconds(s) for s in floods) / blocks
