"""Client-gradient bytes aggregated a second: the f32 bytes of every
client gradient that the window's rounds folded (N × params × 4 a round),
over the window's host-clock length. Bytes handed in, not wire bytes."""


def read(rec):
    per_round = rec["work"].get("agg_bytes")
    if not per_round:
        return None
    return per_round * rec["rounds"] / rec["window_s"] / 1e9
