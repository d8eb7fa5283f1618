"""Explicit device: the port's entry points default to ``"cuda"`` and
raise without a card instead of carrying on on the CPU; ``"auto"``
picks the backend from the lattice's device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.lattice_engine import lattice_stats, resolve_backend  # noqa: E402,E501
from repro_torch.losses.lattice import (batch_lattices,  # noqa: E402
                                        make_lattice_batch,
                                        make_sausage_lattice)
from repro_torch.serving import packing  # noqa: E402
from repro_torch.serving.service import RescoringService  # noqa: E402
from repro_torch.serving.streaming import StreamSession  # noqa: E402


@pytest.fixture
def no_card(monkeypatch):
    """This process as a machine without a CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _dict():
    return make_sausage_lattice(np.random.default_rng(0), num_frames=8,
                                num_states=4)


def test_cuda_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        batch_lattices([_dict()])
    with pytest.raises(RuntimeError):
        make_lattice_batch(0, batch=1, num_frames=8, num_states=4)
    spec = packing.BucketSpec(1, 8, 8, 4, 4, 4)
    with pytest.raises(RuntimeError):
        RescoringService([spec])
    with pytest.raises(RuntimeError):
        StreamSession(spec, kappa=0.5)
    with pytest.raises(RuntimeError):
        packing.pack_requests([_dict()], spec._replace(num_arcs=6, fan=3))


def test_unknown_device_type_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_cpu_is_taken_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    lat = batch_lattices([_dict()], device="cpu")
    assert lat.start_t.device.type == "cpu"


def test_auto_on_cpu_tensors_resolves_to_levelized():
    lat = batch_lattices([_dict()], device="cpu")
    assert resolve_backend("auto", lat) == "levelized"
    lp = torch.log_softmax(torch.zeros(1, 8, 4), -1)
    auto = lattice_stats(lat, lp, 0.5)
    lev = lattice_stats(lat, lp, 0.5, backend="levelized")
    for a, b in zip(auto, lev):
        assert torch.equal(a, b)
