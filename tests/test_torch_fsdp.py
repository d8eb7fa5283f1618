"""The FSDP pieces of the port on their own, on two and on four gloo
ranks (``launch.fsdp``, ``launch.mesh.Mesh.group``, ``core.tree_math``'s
reductions, the gathering ``checkpoint.io.save_checkpoint``).

Each rank holds its share of a small tree with a leaf of every kind:
split over "data" and "model", over "data" only, over "model" only,
replicated, and a stacked leaf split over both and gathered one period
at a time.  A toy model (``tests/torch_mesh_lm_worker.py::_toy``) uses
the leaves through ``gather_for_compute``, as the LM backbones do, and
is held against the same model on the whole leaves:

  * the forward, ``torch.func.jvp`` and ``torch.func.linearize``: the
    same bits (the gather moves bits; the model then runs as on the
    whole leaves);
  * ``torch.func.vjp`` on rows kept whole on every rank: each leaf's
    cotangent is its slice of the whole one, the same bits;
  * ``torch.func.vjp`` and ``torch.autograd`` on each data rank's own
    rows: the gathers' reduce-scatter and ``core.curvature.batch_sum``
    give each rank its share of the whole gradient, within 2e-6
    (sums in another order);
  * the cast before the gather under 2d storage: a matrix arrives in the
    compute dtype with the whole leaf's cast bits, a vector in f32;
  * ``tree_math.vdot`` and ``norm`` inside ``reducing`` of the split
    tree's layout against the whole tree's, rtol 1e-6, the same bits on
    every rank;
  * ``Mesh.group`` of a leaf split over "data" and "model": the world;
  * a checkpoint saved from the shares: ``manifest.json`` and every
    array of ``arrays.npz`` byte-equal to a one-process save of the
    whole tree (the zip's own entry times aside), and loaded back into
    each rank's shares.

Meshes: 2x2 (four ranks) and 2x1 (two; "model" of extent 1, so the
model-split leaves stay whole).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as W  # noqa: E402

MESHES = {"2x2": 4, "2x1": 2}
GRAD_ATOL = 2e-6


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """Every rank's results, by mesh; both meshes run at once."""
    started = {mesh: W.start("torch_mesh_lm_worker:fsdp_units", n,
                             tmp_path_factory.mktemp(f"fsdp_{mesh}"),
                             mesh=mesh)
               for mesh, n in MESHES.items()}
    return {mesh: W.finish(h) for mesh, h in started.items()}


@pytest.fixture(params=sorted(MESHES))
def outs(request, units):
    got = units[request.param]
    assert len(got) == MESHES[request.param]
    return got


def test_group_of_a_2d_leaf_is_the_world(outs):
    for o in outs:
        assert o["group_2d"].all()


def test_gathered_forward_is_the_whole_leaves(outs):
    for o in outs:
        assert bool(o["forward"])


def test_jvp_through_the_gather(outs):
    for o in outs:
        assert float(o["jvp"]) == 0.0


def test_linearize_through_the_gather(outs):
    for o in outs:
        assert float(o["linearize"]) == 0.0


def test_vjp_on_whole_rows_takes_each_leafs_slice(outs):
    for o in outs:
        assert float(o["vjp_whole_rows"]) == 0.0


def test_vjp_and_autograd_on_split_rows_sum_over_data(outs):
    for o in outs:
        assert float(o["vjp_split_rows"]) <= GRAD_ATOL
        assert float(o["autograd_split_rows"]) <= GRAD_ATOL


def test_matrices_are_cast_before_the_gather(outs):
    for o in outs:
        assert o["cast"].all()


def test_vdot_and_norm_over_split_trees(outs):
    for o in outs:
        np.testing.assert_allclose(o["vdot_norm"], o["vdot_norm_want"],
                                   rtol=1e-6)
        assert np.array_equal(o["vdot_norm"], outs[0]["vdot_norm"])


def test_gathering_save_is_a_one_process_save(outs):
    for o in outs:
        assert bool(o["ckpt_same"]) and bool(o["ckpt_load"])
