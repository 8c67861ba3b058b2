"""setup.build_s: the host's clock around the public call that builds the
port's object (`SparseLinear.from_dense`; `encode_matrix`, `pack_matrix`
and `to_device`), in s."""


def read(run):
    return run["build_s"]
