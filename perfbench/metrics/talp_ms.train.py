"""talp_ms.train: TALP's own host time per started step of the window, in
ms: the growth of the monitor's overhead accumulator over the window (its
outermost sections: with the program's recorder, the backend's per-launch
markers as ``mark`` and the phase spans' bookkeeping as ``phases``, with
the drains, ingestion and samples) over the steps started."""


def read(rec, cell):
    spent = rec["window"].get("talp_overhead_s")
    if spent is None or not rec["attempted"]:
        return None
    return float(1e3 * spent / rec["attempted"])
