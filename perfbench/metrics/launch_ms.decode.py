"""launch_ms.decode: the mean host time inside ``backend.launch`` per
decode step of the window (the host enqueueing the step's work), in ms;
a span of the harness's, adding no synchronisation."""


def read(rec, cell):
    times = rec["window"]["spans"].get("launch")
    return 1e3 * sum(times) / len(times) if times else None
