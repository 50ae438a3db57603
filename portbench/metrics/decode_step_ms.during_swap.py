"""Milliseconds of a decode step of the whole batch while the watcher works
on a swap: the mean of the program's ``serve.decode`` spans that overlap a
``serve.swap.write`` (the chunked device writes) or a ``decode`` inside
``serve.poll`` (the watcher's npz decode of the new blob), leaving out those
that overlap the profiled sub-window. Beside ``decode_step_ms.chat`` it shows
what a swap costs each token. The records hold spans as (name, start,
seconds): the watcher's spans are the only ones on its thread, so a
``decode`` is the watcher's when it lies inside a ``serve.poll``."""


def _intervals(records: dict, name: str) -> list[tuple[float, float]]:
    return [(s, s + d) for n, s, d in records["spans"] if n == name]


def read(records: dict) -> float | None:
    tr = records.get("trace")
    polls = _intervals(records, "serve.poll")
    busy = _intervals(records, "serve.swap.write") + [
        (a, b) for a, b in _intervals(records, "decode")
        if any(s <= a and b <= e for s, e in polls)]
    steps = [(a, b) for a, b in _intervals(records, "serve.decode")
             if not (tr and a < tr["t1"] and b > tr["t0"])
             and any(a < e and b > s for s, e in busy)]
    return 1e3 * sum(b - a for a, b in steps) / len(steps) if steps else None
