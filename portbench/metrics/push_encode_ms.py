"""Milliseconds a push spends in the codec: the program's ``encode`` spans
(the update serialized, with the codec's own write of the blob) that lie
inside each ``push`` span, summed per push, the mean over the window's pushes
that do not overlap the profiled sub-window. The records hold spans as
(name, start, seconds), so a child is found by its name and its time inside
its parent: the training client records from one thread."""


def _outside(records: dict, name: str) -> list[tuple[float, float]]:
    tr = records.get("trace")
    return [(s, s + d) for n, s, d in records["spans"]
            if n == name and not (tr and s < tr["t1"] and s + d > tr["t0"])]


def read(records: dict) -> float | None:
    parents = _outside(records, "push")
    if not parents:
        return None
    inner = [(s, s + d) for n, s, d in records["spans"] if n == "encode"]
    if not inner:
        return None
    per = [sum(b - a for a, b in inner if s <= a and b <= e) for s, e in parents]
    return 1e3 * sum(per) / len(per)
