"""idle_share.train: the share of the profiled train segment's wall in which
no operation ran on the card, in percent: one less the union of the
device operations' intervals over the segment's host wall."""


def read(rec, cell):
    seg = (rec.get("profile") or {}).get("train")
    if not seg:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["wall_s"])
