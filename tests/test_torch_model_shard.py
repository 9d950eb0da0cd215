"""The port's model-sharded lookups, sparse gradient exchange and routed
pairs (``deepfm_tpu_torch/parallel/embedding_shard.py``) on gloo ranks,
against the JAX package's on the same (data, model) meshes of this
process's virtual CPU devices (tests/conftest.py).

Rank processes (``tests/torch_dp_worker.py::spawn``, targets in
``tests/torch_shard_worker.py``: no JAX in the ranks) run on (2, 2),
(1, 2) and (1, 4) meshes; the JAX lookups run on ``build_mesh(data,
model, devices=jax.devices()[:data * model])``. Each rank holds its slab
of the table and its data index's share of the ids (64 ids, a logical
256 x 17 table, and a packed table of 1792 logical rows of 17 in 256 x
128, pack 7).

Held, with their tolerances:
  * the rows of the psum, all_to_all and "auto" lookups, both layouts:
    equal to table[ids] and to the JAX lookup's bit for bit (a gather, and
    a sum of one row and zeros). Where the JAX all_to_all lookup's rows are
    not table[ids] (its buckets overflowed: ``_a2a_lookup_local`` writes
    each id that does not fit as id 0 into slot 0 of its owner's bucket,
    ``embedding_shard.py:186-189``, over the id that does fit there, so
    the first id of an overflowing bucket may get row 0), the port is held
    to table[ids] alone;
  * the slab's gradient of sum(rows * up), through the sparse gradient
    exchange (plain and routed) or, under "auto", the local densify
    summed over the data group: the JAX gradient's rows of that slab
    within rtol 1e-5 / atol 1e-6 (the duplicate ids' sums in another
    order), the dead lanes of a packed slab exactly 0;
  * ids all on one slab (skew) with the capacities shrunk (and on (1, 4)
    at the default factor, as the JAX test runs it): the fallbacks run
    (counted) and the rows and gradients stay as above;
  * ``route_sorted_pairs`` on (2, 2) against the dense float64 oracle:
    each slab's pairs scatter to that slab of the dense gradient (rtol
    1e-5 / atol 1e-6), the sum of squares summed over the model group
    within rel 1e-5 of the oracle's, no overflow; a skewed stream at
    factor 0.25 overflows on every rank; at factor 8 the flag is None;
  * the mesh's groups (rank r at data index r // m, model index r % m)
    and each collective over them;
  * a model axis that does not divide a table's rows is refused, naming
    both numbers.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_dp_worker  # noqa: E402
import torch_shard_worker  # noqa: E402
from torch_port_helpers import SYNTH_SPEC, schema_pair  # noqa: E402

from deepfm_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from deepfm_tpu.parallel import make_lookup_fn as jax_lookup_fn  # noqa: E402
from deepfm_tpu.parallel import (  # noqa: E402
    make_packed_lookup_factory as jax_packed_factory,
)
from deepfm_tpu.utils.layout import pack_table  # noqa: E402
from deepfm_tpu_torch.config import config_from_dict  # noqa: E402
from deepfm_tpu_torch.data.packing import pack_schema  # noqa: E402
from deepfm_tpu_torch.models import create_model  # noqa: E402
from deepfm_tpu_torch.parallel import Mesh, slab_bounds  # noqa: E402

torch.set_num_threads(1)

N_IDS, V, C = 64, 256, 17
PACKED_V, PACK = 1792, 7
PACKED_PHYS = 256
GRAD_TOL = {"rtol": 1e-5, "atol": 1e-6}
SSQ_REL = 1e-5
MESHES = ((2, 2), (1, 2), (1, 4))
STRATEGIES = ("psum", "all_to_all", "auto")
# (strategy, layout): "auto" keeps logical tables above a model axis of 1;
# "gather" is a logical table under the row-gather lookup
# (pallas.use_embedding_kernel: its plain version on the CPU)
LOOKUPS = [(s, layout) for layout in ("logical", "packed", "gather")
           for s in STRATEGIES if (s, layout) != ("auto", "packed")]
# shrunk capacities: every skewed bucket and routed exchange overflows
SHRUNK = {"ALL_TO_ALL_CAPACITY": 0.5, "ROUTED_EXCHANGE_CAPACITY": 0.25}


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    logical = rng.normal(size=(V, C)).astype(np.float32)
    packed_logical = rng.normal(size=(PACKED_V, C)).astype(np.float32)
    packed = np.asarray(pack_table(packed_logical, C, PACK, PACKED_PHYS))
    return logical, packed_logical, packed


def _ids(rows, seed, skew_from=None):
    rng = np.random.default_rng(seed)
    lo = 0 if skew_from is None else skew_from
    ids = rng.integers(lo, rows, N_IDS).astype(np.int64)
    up = rng.normal(size=(N_IDS, C)).astype(np.float32)
    return ids, up


def _cases(m):
    """(name, strategy, layout, skewed, factors) of the lookups on a
    model axis of ``m``."""
    out = []
    for strategy, layout in LOOKUPS:
        out.append((f"{strategy}_{layout}", strategy, layout, False, None))
        if strategy == "all_to_all":
            out.append((f"{strategy}_{layout}_skewed", strategy, layout,
                        True, SHRUNK if m == 2 else None))
    return out


def _jax_lookup(mesh, strategy, layout):
    if layout == "logical":
        fn = jax_lookup_fn(mesh, strategy)
        return fn if fn is not None else (
            lambda t, i: jnp.take(t, i, axis=0))
    return jax_packed_factory(mesh, strategy)(C, PACK)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_shard")
    logical, packed_logical, packed = _tables()
    out = {"cases": {}, "ranks": {}}
    for axes in MESHES:
        d, m = axes
        mesh = jax_build_mesh(d, m, devices=jax.devices()[:d * m])
        cases, want = [], {}
        for i, (name, strategy, layout, skewed, factors) in enumerate(
                _cases(m)):
            packed_layout = layout == "packed"
            rows = PACKED_V if packed_layout else V
            ids, up = _ids(rows, seed=10 * i + m,
                           skew_from=rows - rows // m if skewed else None)
            table = packed if packed_layout else logical
            lookup = _jax_lookup(mesh, strategy,
                                 "packed" if packed_layout else "logical")
            jrows = jax.jit(lookup)(jnp.asarray(table),
                                    jnp.asarray(ids, jnp.int32))
            jgrad = jax.jit(jax.grad(lambda t, lookup=lookup, ids=ids, up=up:
                                     jnp.sum(lookup(t, jnp.asarray(
                                         ids, jnp.int32)) * up)))(
                jnp.asarray(table))
            whole = packed_logical if packed_layout else logical
            want[name] = {"rows": np.asarray(jrows), "grad": np.asarray(jgrad),
                          "gather": whole[ids], "skewed": skewed,
                          "strategy": strategy, "factors": factors}
            cases.append({"name": name, "strategy": strategy, "table": table,
                          "ids": ids, "up": up, "factors": factors,
                          "gather_kernel": layout == "gather",
                          "geom": (C, PACK) if packed_layout else None})
        out["cases"][axes] = want
        out["ranks"][axes] = torch_dp_worker.spawn(
            d * m, torch_shard_worker.lookups, (cases,),
            tmp / f"lookups_{d}x{m}", axes=axes)
    return out


def _mesh_of(axes, rank):
    d, m = axes
    return Mesh(data=d, model=m, rank=rank, world=d * m, local_rank=rank,
                device=torch.device("cpu"), backend=None)


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("strategy,layout", LOOKUPS)
def test_lookup_rows_and_slab_gradients_match_jax(runs, axes, strategy,
                                                  layout):
    names = [n for n in runs["cases"][axes]
             if n.startswith(f"{strategy}_{layout}")]
    assert names
    for name in names:
        want = runs["cases"][axes][name]
        k = [c[0] for c in _cases(axes[1])].index(name)
        for rank, result in enumerate(runs["ranks"][axes]):
            got = result[k]
            mesh = _mesh_of(axes, rank)
            per = N_IDS // axes[0]
            share = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
            np.testing.assert_array_equal(got["rows"].numpy(),
                                          want["gather"][share],
                                          err_msg=name)
            if np.array_equal(want["rows"], want["gather"]):
                np.testing.assert_array_equal(got["rows"].numpy(),
                                              want["rows"][share],
                                              err_msg=name)
            else:  # the JAX lookup's overflow fault (module docstring)
                assert want["skewed"] and strategy == "all_to_all", name
            lo, hi = slab_bounds(mesh, want["grad"].shape[0])
            np.testing.assert_allclose(got["grad"].numpy(),
                                       want["grad"][lo:hi], err_msg=name,
                                       **GRAD_TOL)
            if layout == "packed":
                dead = got["grad"].numpy()[:, PACK * C:]
                np.testing.assert_array_equal(dead, np.zeros_like(dead))


@pytest.mark.parametrize("axes", MESHES)
def test_skewed_ids_take_the_exact_fallbacks(runs, axes):
    for name, want in runs["cases"][axes].items():
        if not want["skewed"]:
            continue
        k = [c[0] for c in _cases(axes[1])].index(name)
        taken = [r[k]["fallbacks"] for r in runs["ranks"][axes]]
        # every rank of a model group runs the lookup's fallback together
        assert all(t["lookup"] == 1 for t in taken), (name, taken)
        if axes[0] > 1:  # the routed exchange needs a data axis
            assert all(t["exchange"] == 1 for t in taken), (name, taken)
        else:
            assert all(t["exchange"] == 0 for t in taken), (name, taken)


@pytest.mark.parametrize("axes", MESHES)
def test_unskewed_ids_take_no_fallback(runs, axes):
    for name, want in runs["cases"][axes].items():
        if want["skewed"]:
            continue
        k = [c[0] for c in _cases(axes[1])].index(name)
        for r in runs["ranks"][axes]:
            assert r[k]["fallbacks"] == {"lookup": 0, "exchange": 0,
                                         "route_sorted_pairs": 0}, name


# --------------------------------------------------------------------------
# route_sorted_pairs, the mesh's groups, the collectives
# --------------------------------------------------------------------------

ROUTE_ROWS, ROUTE_N = 64, 256  # logical rows a slab, pairs of the stream


def _dense(ids, ct, rows):
    g = np.zeros((rows, ct.shape[1]), np.float64)
    np.add.at(g, ids, ct.astype(np.float64))
    return g


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("routing")
    total = 2 * ROUTE_ROWS
    cases = []
    for name, factor, skew in (("spread", 1.5, None), ("skewed", 0.25, 0),
                               ("static_fit", 8.0, None)):
        ids, ct = torch_shard_worker.np_stream(ROUTE_N, total if skew is None
                                               else ROUTE_ROWS, C, 5, skew)
        cases.append({"name": name, "ids": ids, "ct": ct, "rows": ROUTE_ROWS,
                      "factors": {"ROUTE_PAIRS_CAPACITY": factor}})
    ranks = torch_dp_worker.spawn(4, torch_shard_worker.routing, (cases,),
                                  tmp / "ranks", axes=(2, 2))
    groups = torch_dp_worker.spawn(4, torch_shard_worker.mesh_groups, (),
                                   tmp / "groups", axes=(2, 2))
    colls = torch_dp_worker.spawn(4, torch_shard_worker.collectives_on_groups,
                                  (), tmp / "colls", axes=(2, 2))
    return cases, ranks, groups, colls


def test_routed_pairs_rebuild_each_slab_of_the_dense_gradient(routed):
    cases, ranks, _, _ = routed
    case = cases[0]
    oracle = _dense(case["ids"], case["ct"], 2 * ROUTE_ROWS)
    for rank, r in enumerate(ranks):
        got = r[0]
        assert got["ovf"] is False
        sids = got["sids"].numpy()
        assert np.all(np.diff(sids) >= 0)  # sorted
        assert sids.min() >= 0 and sids.max() < ROUTE_ROWS
        j = rank % 2
        np.testing.assert_allclose(
            _dense(sids, got["cts"].numpy(), ROUTE_ROWS),
            oracle[j * ROUTE_ROWS:(j + 1) * ROUTE_ROWS], **GRAD_TOL)
        assert got["ssq"] == pytest.approx(float(np.sum(oracle ** 2)),
                                           rel=SSQ_REL)


def test_routed_pairs_overflow_on_skew_and_not_at_a_static_fit(routed):
    _, ranks, _, _ = routed
    for r in ranks:
        assert r[1]["ovf"] is True and r[1]["sids"] is None
        assert r[2]["ovf"] is None and r[2]["sids"] is not None


def test_the_mesh_groups_follow_the_jax_device_order(routed):
    _, _, groups, _ = routed
    for rank, g in enumerate(groups):
        i, j = rank // 2, rank % 2
        assert (g["rank"], g["data_index"], g["model_index"]) == (rank, i, j)
        assert g["data_group"] == [j, j + 2]
        assert g["model_group"] == [2 * i, 2 * i + 1]
        assert g["world_group"] == [0, 1, 2, 3]


def test_collectives_run_over_their_group(routed):
    _, _, _, colls = routed
    for rank, c in enumerate(colls):
        i, j = rank // 2, rank % 2
        for name, ranks in (("data", [j, j + 2]),
                            ("model", [2 * i, 2 * i + 1]),
                            ("world", [0, 1, 2, 3])):
            got = c[name]
            assert got["gather"] == [[float(r), r + 0.5] for r in ranks]
            assert got["sum"] == float(sum(ranks))
            assert got["max"] == float(max(ranks))
            assert got["any"] is (rank == len(ranks) - 1 or any(
                r == len(ranks) - 1 for r in ranks))
            me = ranks.index(rank)
            assert got["a2a"] == [me + 10.0 * r for r in ranks]
        # the model-group sum of 3 * (rank + 1); its gradient the
        # incoming one, 3, as it is
        assert c["model_sum"] == {"value": 3.0 * (4 * i + 3), "grad": 3.0}


# --------------------------------------------------------------------------
# refusal
# --------------------------------------------------------------------------


def test_a_model_axis_that_does_not_divide_the_rows_is_refused():
    mesh = _mesh_of((1, 3), 0)
    with pytest.raises(ValueError, match=r"128 rows, which the mesh's model "
                                         r"axis 3 does not divide"):
        slab_bounds(mesh, 128)
    assert slab_bounds(_mesh_of((1, 4), 3), 128) == (96, 128)
    _, tschema = schema_pair(SYNTH_SPEC)
    config = config_from_dict({"device": "cpu",
                               "dnn": {"hidden_units": [8]},
                               "mesh": {"model_axis": 3}})
    with pytest.raises(ValueError, match=r"model axis 3 does not divide"):
        create_model("deepfm", pack_schema(tschema), config,
                     mesh=dataclasses.replace(mesh, device=torch.device(
                         "cpu")))


def test_the_parallel_package_exports_the_jax_names():
    """``deepfm_tpu_torch.parallel`` exports every name of the JAX
    package's, ``ring_field_attention`` among them; its lookup makers at a
    model axis of 1 are the gather, and the placement helpers follow
    ``placement``."""
    import deepfm_tpu.parallel as jax_parallel
    import deepfm_tpu_torch.parallel as port

    assert set(jax_parallel.__all__) <= set(port.__all__)
    logical, packed_logical, packed = _tables()
    ids = torch.from_numpy(_ids(V, 0)[0])
    one = _mesh_of((1, 1), 0)
    assert torch.equal(port.make_psum_lookup(one)(
        torch.from_numpy(logical), ids), torch.from_numpy(logical)[ids])
    assert torch.equal(port.make_a2a_lookup(one)(
        torch.from_numpy(logical), ids), torch.from_numpy(logical)[ids])
    for make in (port.make_psum_lookup_packed, port.make_a2a_lookup_packed):
        assert torch.equal(make(one, C, PACK)(torch.from_numpy(packed), ids),
                           torch.from_numpy(packed_logical)[ids])
    mesh = _mesh_of((2, 2), 3)
    names = ["embedding.table_w16", "dnn.dense_0.weight"]
    assert port.state_shardings(mesh, names) == {
        names[0]: "rows over model", names[1]: port.replicated(mesh)}
    assert port.batch_shardings(mesh, {"ids": np.zeros(8)}) == {
        "ids": slice(4, 8)}
