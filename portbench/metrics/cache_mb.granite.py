"""Megabytes (1e6 bytes) of a batch's decode cache: the window's growth of
the program's counters ``serve.cache.kv_bytes`` (attention rings) and
``serve.cache.state_bytes`` (conv windows and recurrent states) over its
``serve.cache.init`` spans. None where the program counts neither."""


def read(records: dict) -> float | None:
    counters = records.get("counters") or {}
    total = sum(counters.get(k, 0) for k in ("serve.cache.kv_bytes", "serve.cache.state_bytes"))
    inits = sum(1 for name, _, _ in records["spans"] if name == "serve.cache.init")
    return total / inits / 1e6 if total and inits else None
