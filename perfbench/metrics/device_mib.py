"""device_mib: the peak of the allocator's bytes over the window, less the
bytes the harness held before the port's object was built (inputs, the
flush buffer, kept answers, CG vectors), in MiB. What the warm-up leaves
allocated counts: a solver set captured as a CUDA graph keeps the port's
temporaries of the set (its multiplies' outputs) in the graph's pool, which
a user who captures the set pays."""


def read(run):
    return run.get("device_mib")
