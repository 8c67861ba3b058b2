"""serving.enqueue_us.apply: the mean duration of the port's own
``serving.sparse_apply`` span over the window's calls, in us. The span
has no synchronize: it is the host's time to enqueue a multiply."""


def read(run):
    durs = [s["dur_s"] for s in run.get("spans", [])
            if s["name"] == "serving.sparse_apply"]
    return 1e6 * sum(durs) / len(durs) if durs else None
