"""Training tokens a second: the tokens of every local step of the
window's rounds, over the window's host-clock length."""


def read(rec):
    per_round = rec["work"].get("tokens")
    if not per_round:
        return None
    return per_round * rec["rounds"] / rec["window_s"]
