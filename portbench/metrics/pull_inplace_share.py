"""Share (%) of a pull's decodes that read the deposit in place: 100 × the
program's ``decode.inplace`` spans (one inside each ``decode`` of a stored
full update) that lie inside a ``pull`` span ÷ the ``decode`` spans inside
them, over the window's pulls that do not overlap the profiled sub-window;
a child is found by its name and its time inside its parent, as
``pull_decode_ms`` finds it. None where the program records no
``decode.inplace`` span, as a program that decodes through ``np.load`` does."""


def read(records: dict) -> float | None:
    spans = records["spans"]
    if not any(n == "decode.inplace" for n, _, _ in spans):
        return None
    tr = records.get("trace")
    pulls = [(s, s + d) for n, s, d in spans
             if n == "pull" and not (tr and s < tr["t1"] and s + d > tr["t0"])]

    def inside(name: str) -> int:
        return sum(1 for n, s, d in spans
                   if n == name and any(a <= s and s + d <= b for a, b in pulls))

    decodes = inside("decode")
    return 100.0 * inside("decode.inplace") / decodes if decodes else None
