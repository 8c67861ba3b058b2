"""The port's sharding rules, logical annotations and elastic resharding
against the reference's.

* `ShardingRules.param_spec` / `opt_spec` of every leaf of every
  `ARCH_IDS` config at full width (the reference's leaves from
  `jax.eval_shape(api.init_params)`, the port's from the shape-only meta
  build), on both production layouts as shapes only (the reference's
  ``FakeMesh``, the port's `MeshShape`), with ``fsdp`` None / True /
  False and ``dp_only`` both ways: equal spec for spec.
* `cache_spec` at ``decode_32k`` and ``long_500k``, `batch_axis` and
  `batch_spec` (batches that divide and that do not), `rules_for_mesh`,
  `shrink_data_axis` on a grid of sizes: equal.
* On one gloo group of 4 ranks as a 2 x 2 (data, model) mesh: `reshard`
  gives each rank the slice that the reference's ``NamedSharding`` gives
  the device at the same mesh coordinate (`devices_indices_map` on a
  2 x 2 mesh of the test process's host devices), a dim split over both
  axes included; a shrink to a 2-rank sub-mesh leaves ranks 2-3 with an
  empty shard; `shard` redistributes a DTensor only inside
  `logical_rules`.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import ShardingRules, placements
from repro_torch.models import api
from repro_torch.models import sharding as S
from repro_torch.models.config import SHAPES
from repro_torch.train.elastic import reshard, shrink_data_axis

LAYOUTS = {"single": (("data", "model"), (16, 16)),
           "multi": (("pod", "data", "model"), (2, 16, 16))}
POLICIES = [dict(fsdp=f, dp_only=d) for f in (None, True, False)
            for d in (False, True)]


def _fake_mesh(axes, sizes):
    return type("FakeMesh", (), {"shape": dict(zip(axes, sizes)),
                                 "axis_names": axes})()


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    import jax
    from repro import configs as rconfigs
    from repro.models import api as rapi
    shapes = jax.eval_shape(functools.partial(rapi.init_params,
                                              rconfigs.get(arch)),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(shapes)[0]


@functools.lru_cache(maxsize=None)
def _port_leaves(arch):
    cfg = configs.get(arch)
    model = api.build_model(cfg, generator=None, device="meta")
    out = {}
    for k, v in api.reference_leaves(model, cfg).items():
        t = v[0] if isinstance(v, list) else v
        out[k] = ((len(v),) if isinstance(v, list) else ()) + tuple(t.shape)
    return out


def _name(path) -> str:
    return ".".join(str(getattr(p, "key", p)) for p in path)


def _rules(arch, layout, **kw):
    from repro import configs as rconfigs
    from repro.launch.sharding import ShardingRules as RRules
    axes, sizes = LAYOUTS[layout]
    return (RRules(rconfigs.get(arch), _fake_mesh(axes, sizes), **kw),
            ShardingRules(configs.get(arch), M.MeshShape(axes, sizes), **kw))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(arch, layout):
    ref = _ref_leaves(arch)
    port = _port_leaves(arch)
    assert [_name(p) for p, _ in ref] == list(port)
    for kw in POLICIES:
        rr, pr = _rules(arch, layout, **kw)
        assert (rr.fsdp, rr.msize, rr.dsize) == (pr.fsdp, pr.msize,
                                                 pr.dsize)
        for path, leaf in ref:
            name = _name(path)
            assert port[name] == tuple(leaf.shape), name
            want = rr.param_spec(path, leaf)
            got = pr.param_spec(name, port[name])
            assert got == tuple(want), (name, kw)
            assert pr.opt_spec(got, leaf.shape) == \
                tuple(rr.opt_spec(want, leaf.shape)), (name, kw)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    import jax
    from repro import configs as rconfigs
    from repro.models import api as rapi
    cfg = configs.get(arch)
    model = api.build_model(cfg, generator=None, device="meta")
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        B, L = shape.global_batch, shape.seq_len
        ref = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            functools.partial(rapi.make_decode_cache, rconfigs.get(arch),
                              B, L)))[0]
        port = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    port[f"{prefix}{k}"] = tuple(v.shape)
        walk(model.make_decode_cache(B, L))
        assert sorted(port) == sorted(_name(p) for p, _ in ref)
        for layout in LAYOUTS:
            for kw in ({}, {"seq_shard_cache": False}, {"dp_only": True}):
                rr, pr = _rules(arch, layout, **kw)
                for path, leaf in ref:
                    name = _name(path)
                    assert port[name] == tuple(leaf.shape)
                    assert pr.cache_spec(name, port[name]) == tuple(
                        rr.cache_spec(path, leaf)), (name, layout, kw)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batch_axis_and_spec_equal_the_reference(layout):
    import jax
    import jax.numpy as jnp
    for dp_only in (False, True):
        rr, pr = _rules("yi-9b", layout, dp_only=dp_only)
        for b in (1, 2, 3, 16, 24, 32, 128, 256, 512, 1000):
            assert pr.batch_axis(b) == rr.batch_axis(b), (b, dp_only)
            shapes = {"inputs": (b, 7), "frontend": (b, 5, 3)}
            want = rr.batch_spec({k: jax.ShapeDtypeStruct(v, jnp.int32)
                                  for k, v in shapes.items()})
            got = pr.batch_spec(shapes)
            assert got == {k: tuple(v) for k, v in want.items()}


def test_rules_for_mesh_and_shard_outside_a_mesh():
    from repro.models.sharding import rules_for_mesh as ref_rules
    for axes in (("data", "model"), ("pod", "data", "model"), ("model",),
                 ("data",)):
        for kw in ({}, {"dp_only": True}, {"batch_axes": "data"},
                   {"seq_axis": "model"}):
            assert S.rules_for_mesh(axes, **kw) == ref_rules(axes, **kw)
    x = torch.arange(6.0).reshape(2, 3)
    assert S.current_rules() is None
    assert S.shard(x, "batch", "d_model") is x
    with S.logical_rules(S.rules_for_mesh(("data", "model"))):
        assert S.current_rules()["heads"] == "model"
        assert S.shard(x, "batch", "heads") is x   # a plain tensor
    assert S.current_rules() is None
    # a later dim wins a mesh axis two dims map to
    rules = S.rules_for_mesh(("data", "model"), seq_axis="model")
    assert S.logical_spec(rules, ("batch", "seq", "heads")) == \
        ("data", None, "model")


def test_shrink_data_axis_equals_the_reference():
    from repro.train.elastic import shrink_data_axis as ref_shrink
    for g in (1, 7, 16, 96, 256, 1000):
        for old in (1, 2, 4, 16):
            for new in (1, 2, 3, 4, 8, 16, 32):
                assert shrink_data_axis(g, old, new) == \
                    ref_shrink(g, old, new)


def test_mesh_shapes():
    single = M.abstract_production_mesh()
    multi = M.abstract_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.ndevices == 512
    assert (M.data_axis_names(multi), M.data_axis_size(multi),
            M.model_axis_size(multi)) == (("pod", "data"), 32, 16)
    with pytest.raises(ValueError):
        M.MeshShape(("data",), (2, 2))
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("model", "data"),), M.MeshShape(("data", "model"),
                                                     (2, 2)))


def test_shape_only_build_refuses_other_devices():
    cfg = configs.get_smoke("smollm-135m")
    with pytest.raises(ValueError, match="meta"):
        api.build_model(cfg, generator=None, device="cpu")
    m = api.build_model(cfg, generator=None, device="meta")
    assert all(p.is_meta for p in m.parameters())


# ---------------------------------------------------------------------------
# a 2 x 2 gloo mesh
# ---------------------------------------------------------------------------

X_SHAPE = (8, 12)
SPECS = [(None, None), ("data", None), (None, "model"), ("data", "model"),
         ("model", "data"), (("data", "model"), None),
         (None, ("data", "model"))]


def _x():
    return torch.arange(float(np.prod(X_SHAPE))).reshape(X_SHAPE)


def mesh_body(mesh):
    """One rank of the 2 x 2 group: its local slice of `_x` under each of
    `SPECS`, a shrink to the first two ranks, and `shard` of a DTensor."""
    out = {"coord": tuple(mesh.get_coordinate())}
    x = _x()
    out["locals"] = [reshard(x, mesh, s).to_local().numpy() for s in SPECS]
    small = M.make_debug_mesh((2,), ("data",), "cpu")
    d = reshard(x, small, ("data", None))
    out["small"] = (small.get_coordinate(), tuple(d.to_local().shape))
    back = reshard({"w": [d]}, mesh, {"w": [("data", "model")]})
    out["back"] = back["w"][0].to_local().numpy()
    dt = reshard(x, mesh, (None, None))
    out["shard_outside"] = S.shard(dt, "batch", "heads") is dt
    with S.logical_rules(S.rules_for_mesh(("data", "model"))):
        moved = S.shard(dt, "batch", "heads")
    out["shard_inside"] = moved.to_local().numpy()
    return out


@pytest.fixture(scope="module")
def mesh_ranks():
    return M.spawn(4, mesh_body, device_type="cpu", shape=(2, 2),
                   axes=("data", "model"))


def _ref_slices():
    """The reference's slice of each spec for each device of a 2 x 2
    (data, model) mesh, by mesh coordinate."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 host devices")
    devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("data", "model"))
    out = []
    for spec in SPECS:
        m = NamedSharding(mesh, P(*spec)).devices_indices_map(X_SHAPE)
        out.append({(i, j): m[devs[i, j]] for i in range(2)
                    for j in range(2)})
    return out


def test_reshard_gives_the_reference_slices(mesh_ranks):
    ref = _ref_slices()
    x = _x().numpy()
    assert sorted(r["coord"] for r in mesh_ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in mesh_ranks:
        for spec, got, want in zip(SPECS, r["locals"], ref):
            np.testing.assert_array_equal(got, x[want[r["coord"]]],
                                          err_msg=str(spec))


def test_shrink_to_a_sub_mesh_empties_the_other_ranks(mesh_ranks):
    assert [r["small"] for r in mesh_ranks] == \
        [((0,), (4, 12)), ((1,), (4, 12)), (None, (0,)), (None, (0,))]
    ref = _ref_slices()[3]
    x = _x().numpy()
    for r in mesh_ranks:      # from the sub-mesh back onto all four ranks
        np.testing.assert_array_equal(r["back"], x[ref[r["coord"]]])


def test_shard_redistributes_a_dtensor_inside_logical_rules(mesh_ranks):
    """A replicated DTensor annotated ("batch", "heads") moves to the
    batch on "data" and the heads on "model": the (data, model) slice."""
    ref = _ref_slices()[3]
    x = _x().numpy()
    for r in mesh_ranks:
        assert r["shard_outside"]
        np.testing.assert_array_equal(r["shard_inside"], x[ref[r["coord"]]])
