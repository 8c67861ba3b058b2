"""apply_ms: the mean latency of the window's calls (sum over every call of
its start to its result complete, over the number of calls), in ms."""


def read(run):
    lat = run.get("latencies_s")
    return 1e3 * sum(lat) / len(lat) if lat else None
