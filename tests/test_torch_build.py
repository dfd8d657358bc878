"""The host path of a kernel launch, on the CPU: ``_build.load`` declares a
library's signatures once, the spacings are rounded without a tensor, and
the stage-4 wrappers keep the sums' scratch per device and stream.

``_build.load`` runs on every launch of every wrapper; a call that brings
no new symbol must set no ``restype`` or ``argtypes`` (each assignment is
host time the kernel waits behind). A fake CDLL placed in
``_build._LOADED`` records every assignment. ``stencil.rounded`` (the
spacings a launch takes) must round f32 and f64 without a tensor, bitwise
as a tensor does, and ``stage4_kernels._scratch`` must hand the same
(partials, ticket) pair back for one (device, stream) and a new one for
any other, and keep none made inside a CUDA graph capture: the pair of
``ops.scratch``, which the K-d family shares
(``tests/test_torch_stencil_dots.py``).
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.ops import scratch as sc
from poisson_ellipse_tpu_torch.ops import stage4_kernels as s4
from poisson_ellipse_tpu_torch.ops.stencil import rounded


class _Symbol:
    """A ctypes function stand-in that logs each attribute set on it."""

    def __init__(self, log, name):
        object.__setattr__(self, "_log", log)
        object.__setattr__(self, "_name", name)

    def __setattr__(self, attr, value):
        self._log.append((self._name, attr))
        object.__setattr__(self, attr, value)


class _FakeLib:
    """A CDLL stand-in: symbols made on first access, as ctypes does."""

    def __init__(self, scratch_len=8):
        self.log = []
        self.scratch_len = scratch_len
        self.lengths_asked = []

    def __getattr__(self, name):
        if not name.startswith("pe_"):
            raise AttributeError(name)
        symbol = _Symbol(self.log, name)
        object.__setattr__(self, name, symbol)
        return symbol

    def pe_stage4_scratch_len(self, device):
        self.lengths_asked.append(device)
        return self.scratch_len

    def pe_stage4_error_string(self, code):
        return f"error {code}".encode()


_I, _P = ctypes.c_int, ctypes.c_void_p
SIGS = {"pe_a": (_I, [_P, _I]), "pe_b": (_I, [_P])}


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setitem(_build._LOADED, "fake", lib)
    monkeypatch.setattr(_build, "_DECLARED", {})
    return lib


def test_load_declares_each_symbol_once(fake):
    assert _build.load("fake", SIGS) is fake
    assert sorted(fake.log) == [("pe_a", "argtypes"), ("pe_a", "restype"),
                                ("pe_b", "argtypes"), ("pe_b", "restype")]
    assert fake.pe_a.argtypes == [_P, _I] and fake.pe_b.restype is _I
    fake.log.clear()
    for _ in range(3):
        assert _build.load("fake", SIGS) is fake
    _build.load("fake", {"pe_b": SIGS["pe_b"]})
    assert fake.log == []


def test_load_declares_new_symbols(fake):
    _build.load("fake", SIGS)
    fake.log.clear()
    more = {**SIGS, "pe_c": (ctypes.c_char_p, [_I])}
    _build.load("fake", more)
    assert sorted(fake.log) == [("pe_c", "argtypes"), ("pe_c", "restype")]
    assert fake.pe_c.restype is ctypes.c_char_p
    fake.log.clear()
    _build.load("fake", more)
    assert fake.log == []


def test_libraries_keep_their_own_declared_sets(fake, monkeypatch):
    other = _FakeLib()
    monkeypatch.setitem(_build._LOADED, "other", other)
    _build.load("fake", SIGS)
    _build.load("other", SIGS)
    assert len(other.log) == 4
    assert _build._DECLARED == {"fake": set(SIGS), "other": set(SIGS)}


def _bits(v: float) -> bytes:
    return struct.pack("<d", v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_rounded_is_bitwise_the_tensor_rounding(dtype):
    """``rounded`` rounds f32 and f64 on the host without a tensor: the
    published grids' spacings, ties and near-ties of f32, the guard and
    tolerances, values that round to f32 subnormals or to zero, and a
    spread of magnitudes from a seed, each bitwise a 0-d tensor's value."""
    rng = np.random.default_rng(3)
    hs = [2.0 / m for m in (10, 20, 40, 400, 800, 1100, 1600, 2400)]
    hs += [1.2 / n for n in (10, 20, 40, 600, 1200, 1650, 2400, 3200)]
    hs += [1.0 + 2.0**-24, 1.0 + 3 * 2.0**-24, 1.0 - 2.0**-25, 0.1, 1 / 3]
    hs += [1e-15, 1e-6, 1e-4, 1e-40, 3e-45, 1e-50, 0.0, -0.0, -0.01]
    hs += list(rng.random(200) * 10.0 ** rng.integers(-8, 8, 200))
    for h in hs:
        got = rounded(float(h), dtype)
        assert type(got) is float
        assert _bits(got) == _bits(float(torch.tensor(float(h),
                                                      dtype=dtype))), h


@pytest.fixture
def scratch(monkeypatch):
    """An empty scratch cache, outside any capture."""
    monkeypatch.setattr(sc, "_SCRATCH", {})
    monkeypatch.setattr(sc, "_RETIRED", [])
    monkeypatch.setattr(s4, "_LENGTHS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return _FakeLib(scratch_len=16)


def test_scratch_is_kept_per_device_and_stream(scratch):
    cpu0, cpu = torch.device("cpu", 0), torch.device("cpu")
    partials, ticket = s4._scratch(scratch, cpu0, 11)
    assert partials.dtype == torch.float64 and partials.numel() == 16
    assert ticket.dtype == torch.int32 and ticket.tolist() == [0]
    again = s4._scratch(scratch, cpu0, 11)
    assert again[0] is partials and again[1] is ticket
    other_stream = s4._scratch(scratch, cpu0, 12)
    other_device = s4._scratch(scratch, cpu, 11)
    for pair in (other_stream, other_device):
        assert pair[0] is not partials and pair[1] is not ticket
    assert set(sc._SCRATCH) == {(0, 11), (0, 12), (None, 11)}
    # the length is asked once a device
    assert scratch.lengths_asked == [0, None]


def test_scratch_made_inside_a_capture_is_not_kept(scratch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    first = s4._scratch(scratch, torch.device("cpu", 0), 11)
    second = s4._scratch(scratch, torch.device("cpu", 0), 11)
    assert first[1].tolist() == [0] and second[0] is not first[0]
    assert sc._SCRATCH == {}


def test_scratch_length_error_raises(scratch):
    scratch.scratch_len = -101
    with pytest.raises(RuntimeError, match="101"):
        s4._scratch(scratch, torch.device("cpu", 0), 11)
    assert sc._SCRATCH == {} and s4._LENGTHS == {}
