"""The port's prefill and decode steps on a mesh against one process.

``launch.steps.build_prefill_step(cfg, mesh=)`` and ``build_serve_step(
cfg, mesh=)`` on gloo CPU meshes of 1x2, 2x2 and 1x4 ranks (one process a
rank, one spawn a mesh: ``tests/torch_serve_mesh_worker.py``), each rank
holding its share of the parameters (``param_shardings``) and only its
share of the decode caches (``Model.init_cache(mesh=)``, cut by
``input_shardings``: attention slots over "model", the RG-LRU's and the
xLSTM's states by channels, ``enc_out`` by rows):

* every rank's prefill logits of its rows equal one process's within
  1e-5 of the largest logit;
* every decode step's logits too, the cache filled token by token past a
  ring's length and past the first rank's slots (a write by another
  rank);
* each cache share has the shape of its ``input_shardings`` spec's shard
  and equals that piece of one process's cache within 1e-5;
* no collective of a decode step other than a parameter gather moves as
  many bytes as a layer's share of an attention k/v or mLSTM C cache:
  no cache is gathered.

The cases cover every kind of cache: qwen2.5-3b (GQA, its long-mode
ring, and replicated whole units over split slots), recurrentgemma-9b
(the RG-LRU and a local ring), xlstm-125m (mLSTM and sLSTM, with their
units split by heads and, at 2 heads, whole), granite-moe-3b-a800m
(experts split) and whisper-base (enc-dec).  The one-process port is held
against the JAX prefill and decode by ``tests/test_torch_lm.py``,
``test_torch_dense.py``, ``test_torch_moe.py``, ``test_torch_xlstm.py``
and ``test_torch_encdec.py``.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as W  # noqa: E402
import torch_serve_mesh_worker as S  # noqa: E402

TOL = 1e-5
MESHES = {
    "1x2": ["qwen", "qwen_long", "qwen_repl", "rg", "xlstm", "granite",
            "whisper"],
    "2x2": ["qwen", "rg", "xlstm", "xlstm_h2", "granite", "whisper"],
    "1x4": ["qwen", "qwen_long", "xlstm", "xlstm_h2", "granite", "whisper"],
}
CASES = [(m, c) for m, cases in MESHES.items() for c in cases]
_ONE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one(case: str) -> dict:
    if case not in _ONE:
        _ONE[case] = S.one_process(case)
    return _ONE[case]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: every rank's results} of one spawn of each mesh's ranks, all
    started at once; the one-process results are computed while the
    ranks run."""
    started = {}
    for mesh, cases in MESHES.items():
        d, m = (int(v) for v in mesh.split("x"))
        started[mesh] = W.start("torch_serve_mesh_worker:serve", d * m,
                                tmp_path_factory.mktemp(f"serve{mesh}"),
                                mesh=mesh, cases=cases)
    for case in {c for _, c in CASES}:
        one(case)
    return {mesh: W.finish(s) for mesh, s in started.items()}


def _rows(out: dict, n: int) -> slice:
    """The global batch rows of a rank's ``n`` rows."""
    if n == S.BATCH:
        return slice(0, n)
    lo = int(out["data_index"]) * n
    return slice(lo, lo + n)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mesh,case", CASES)
def test_prefill_logits_match_one_process(runs, mesh, case):
    want = one(case)["prefill"]
    for out in runs[mesh]:
        got = out[f"{case}/prefill"]
        rows = _rows(out, got.shape[0])
        assert got.shape == (rows.stop - rows.start, 1, want.shape[-1])
        assert _rel(got, want[rows]) <= TOL


@pytest.mark.parametrize("mesh,case", CASES)
def test_decode_logits_match_one_process(runs, mesh, case):
    want = one(case)["decode"]
    assert want.shape[0] >= 8
    for out in runs[mesh]:
        got = out[f"{case}/decode"]
        rows = _rows(out, got.shape[1])
        assert got.shape[0] == want.shape[0]
        for t in range(want.shape[0]):
            assert _rel(got[t], want[t, rows]) <= TOL, t


def _specs(mesh: str, case: str) -> dict:
    """{cache path: (whole shape, spec)} by ``input_shardings`` on a
    shape-only stand-in of the mesh."""
    from repro_torch.launch.sharding import input_shardings
    from repro_torch.models.registry import get_model
    d, m = (int(v) for v in mesh.split("x"))
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": d, "model": m})
    kw = S.SERVE_CASES[case]
    shapes = get_model(S.serve_cfg(case)).cache_shapes(
        S.BATCH, kw["slots"], long_mode=kw.get("long_mode", False))
    specs = input_shardings(S.serve_cfg(case), stand_in,
                            {"cache": shapes})["cache"]
    return {k: (shape, specs[k], stand_in)
            for k, (shape, _) in shapes.items()}


def _piece(whole: np.ndarray, spec, stand_in, coord: dict) -> tuple:
    """(share shape, this rank's piece of ``whole``) by ``spec``."""
    index = []
    for n, e in zip(whole.shape, list(spec) + [None] * whole.ndim):
        if e is None:
            index.append(slice(None))
            continue
        axes = (e,) if isinstance(e, str) else e
        pieces = math.prod(stand_in.shape[a] for a in axes)
        at = 0
        for a in axes:
            at = at * stand_in.shape[a] + coord[a]
        index.append(slice(at * n // pieces, (at + 1) * n // pieces))
    piece = whole[tuple(index)]
    return piece.shape, piece


@pytest.mark.parametrize("mesh,case", CASES)
def test_cache_shares_are_the_spec_shards_of_one_process_cache(runs, mesh, case):
    specs = _specs(mesh, case)
    want = one(case)
    split = set()
    for out in runs[mesh]:
        coord = {"data": int(out["data_index"]),
                 "model": int(out["model_index"])}
        for path, (shape, spec, stand_in) in specs.items():
            got = out[f"{case}/cache.{path}"]
            whole = want[f"cache.{path}"]
            assert whole.shape == shape
            share, piece = _piece(whole, spec, stand_in, coord)
            assert got.shape == share, path
            if got.shape != shape:
                split.add(path.split(".")[-1])
            scale = max(float(np.abs(whole).max()), 1e-30)
            if path.split(".")[-1] == "m":       # the -1e30 start
                scale = 1.0
            assert float(np.abs(got - piece).max()) <= TOL * scale, path
    # the layout cuts every kind of cache on these meshes
    kinds = {"qwen": {"k", "v"}, "rg": {"k", "v", "state", "conv"},
             "xlstm": {"C", "n", "conv", "c", "h"},
             "granite": {"k", "v"}, "whisper": {"k", "v"}}
    assert kinds[case.split("_")[0]] <= split
    if case == "whisper" and not mesh.startswith("1x"):
        assert "enc_out" in split     # filled by prefill_cache on its rows


@pytest.mark.parametrize("mesh,case", CASES)
def test_no_decode_collective_moves_a_cache(runs, mesh, case):
    """The largest collective of any decode step outside the parameter
    gathers moves fewer bytes than the smallest layer share of an
    attention k/v or mLSTM C cache leaf (the gathered q, k/v and gates,
    the combine's sums, the logits are per-token vectors)."""
    specs = _specs(mesh, case)
    for out in runs[mesh]:
        shares = []
        for path, (shape, spec, stand_in) in specs.items():
            if path.split(".")[-1] not in ("k", "v", "C"):
                continue
            got = out[f"{case}/cache.{path}"]
            layers = shape[0] if path.startswith("periods.") else 1
            shares.append(got.nbytes // layers)
        assert shares
        assert 0 < int(out[f"{case}/coll_bytes"]) < min(shares), \
            str(out[f"{case}/coll"])
