"""The kernels' launch path (tpuzlib_torch/kernels/_build.py, _clib.py) on
the CPU, with the card's lookups replaced by fakes.

`_build.launch` calls a C entry point resolved once when the library was
loaded, on PyTorch's current stream of the tensor's device (read on every
call), entering a device guard only for a device other than the current
one, and counts the launch.  Here the resolved entry points
(`lib.fns`), the stream lookup (`_raw_stream`), the current device
(`_current_device`) and the guard (`torch.cuda.device`) are fakes, so the
path's contract is held without a card: the arguments in order with the
stream last, the counts, the refusal, the guard, and a library loaded and
resolved once.
"""

import ctypes
import threading

import pytest
import torch

from tpuzlib_torch import _clib
from tpuzlib_torch.kernels import _build

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


class Card:
    """Fakes of the card's lookups: device `current` is current, device i's
    stream is 1000 + i, every guard entered is recorded, and the entry
    point `tz_fake` records its arguments and returns `err`."""

    def __init__(self, monkeypatch, current=0, err=0):
        self.current, self.err = current, err
        self.calls, self.guards, self.streams_read = [], [], []
        fns = {"tz_fake": self.entry, "tz_error_string": lambda e: b"fake error %d" % e}
        monkeypatch.setattr(_build.lib, "fns", fns)
        monkeypatch.setattr(_build, "_raw_stream", self.stream)
        monkeypatch.setattr(_build, "_current_device", lambda: self.current)
        monkeypatch.setattr(torch.cuda, "device", self.guard)
        monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(("a", "b", "c"), 0))

    def entry(self, *args):
        self.calls.append((args, self.current))
        return self.err

    def stream(self, index):
        self.streams_read.append(index)
        return 1000 + index

    def guard(self, index):
        card = self

        class Guard:
            def __enter__(self):
                card.guards.append(index)
                self.before, card.current = card.current, index

            def __exit__(self, *exc):
                card.current = self.before

        return Guard()


@pytest.mark.parametrize("device", [0, torch.device("cuda", 0), torch.device("cuda")])
def test_arguments_reach_the_entry_point_in_order_with_the_stream_last(monkeypatch, device):
    card = Card(monkeypatch)
    _build.launch("a", "tz_fake", device, 11, 22, 33, 44)
    assert card.calls == [((11, 22, 33, 44, 1000), 0)]
    assert card.streams_read == [0]
    assert card.guards == []


def test_launches_count_one_under_each_name(monkeypatch):
    card = Card(monkeypatch)
    _build.launch("a", "tz_fake", 0)
    _build.launch(("b", "c"), "tz_fake", 0, 5)
    _build.launch(("a", "c"), "tz_fake", 0, 6)
    assert _build.LAUNCHES == {"a": 2, "b": 1, "c": 2}
    assert len(card.calls) == 3


def test_a_refused_launch_raises_and_counts_nothing(monkeypatch):
    Card(monkeypatch, err=9)
    with pytest.raises(RuntimeError, match=r"^b launch failed: fake error 9$"):
        _build.launch("b", "tz_fake", 0, 1, 2)
    with pytest.raises(RuntimeError, match="fake error 9"):
        _build.launch(("a", "c"), "tz_fake", 0)
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("device", [1, torch.device("cuda", 1)])
def test_another_device_enters_its_guard(monkeypatch, device):
    """A tensor on device 1 while 0 is current: the call runs inside 1's
    guard, on 1's stream, and 0 is current again afterwards; a tensor on
    the current device enters no guard."""
    card = Card(monkeypatch, current=0)
    _build.launch("a", "tz_fake", device, 7)
    assert card.guards == [1]
    assert card.calls == [((7, 1001), 1)]
    assert card.current == 0
    card.current = 1
    _build.launch("a", "tz_fake", device, 8)
    assert card.guards == [1]
    assert card.calls[-1] == ((8, 1001), 1)


def test_the_stream_is_read_on_every_call(monkeypatch):
    """The current stream is never cached: a new stream between two calls
    reaches the second."""
    card = Card(monkeypatch)
    _build.launch("a", "tz_fake", 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 5000 + index)
    _build.launch("a", "tz_fake", 0)
    assert [args[-1] for args, _ in card.calls] == [1000, 5000]


def test_ticket_takes_the_same_stream_lookup(monkeypatch):
    """ticket() keys its tensor by device index and the raw current stream."""
    card = Card(monkeypatch, current=2)
    made = []
    monkeypatch.setattr(_build, "_ticket", lambda index, stream: made.append((index, stream)))
    _build.ticket(torch.device("cuda", 3))
    _build.ticket(torch.device("cuda"))
    _build.ticket(0)
    assert made == [(3, 1003), (2, 1002), (0, 1000)]
    assert card.streams_read == [3, 2, 0]


class FakeDLL:
    """What ctypes.CDLL gives: an attribute a symbol."""

    loads = 0

    def __init__(self, path):
        type(self).loads += 1
        self.path = path
        for name in ("tz_one", "tz_two"):
            setattr(self, name, type("Fn", (), {})())


def test_a_loaded_library_is_not_built_or_resolved_again(monkeypatch, tmp_path):
    """lib() builds and loads once, from any number of threads at once;
    every entry point of its signatures is resolved with its types then,
    and later calls take no lock."""
    builds = []
    monkeypatch.setattr(_clib.ctypes, "CDLL", FakeDLL)
    FakeDLL.loads = 0
    sigs = {"tz_one": (ctypes.c_int, [ctypes.c_void_p]), "tz_two": (ctypes.c_char_p, [])}
    lib = _clib.Library("fake", lambda: "cc", [], lambda: [], str(tmp_path), sigs)
    monkeypatch.setattr(lib, "build", lambda: builds.append(1) or "libfake.so")
    assert lib.fns is None
    threads = [threading.Thread(target=lib) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    handle = lib()
    assert builds == [1] and FakeDLL.loads == 1
    assert lib() is handle and builds == [1]
    assert set(lib.fns) == {"tz_one", "tz_two"}
    assert lib.fns["tz_one"] is handle.tz_one
    assert lib.fns["tz_one"].restype is ctypes.c_int
    assert lib.fns["tz_one"].argtypes == [ctypes.c_void_p]
    assert lib.fns["tz_two"].restype is ctypes.c_char_p

    class NoLock:
        def __enter__(self):
            raise AssertionError("the lock was taken after the load")

        def __exit__(self, *exc):
            return False

    lib._lock = NoLock()
    assert lib() is handle


def test_launch_loads_the_library_on_its_first_call(monkeypatch):
    """With nothing loaded, launch() loads the library once, then calls."""
    card = Card(monkeypatch)
    fns = _build.lib.fns

    class Unloaded:
        fns, loads = None, 0

        def __call__(self):
            self.loads += 1
            self.fns = fns

    lib = Unloaded()
    monkeypatch.setattr(_build, "lib", lib)
    _build.launch("a", "tz_fake", 0, 3)
    _build.launch("a", "tz_fake", 0, 4)
    assert lib.loads == 1
    assert [args for args, _ in card.calls] == [(3, 1000), (4, 1000)]


def test_every_entry_point_has_a_signature():
    """Each C entry point launch() calls is resolved with its argument
    types (c_void_p for pointers and the stream, so none is cut to 32
    bits), and returns an int."""
    for name, (restype, argtypes) in _build._SIGNATURES.items():
        if name in _build._ARGTYPES:
            assert restype is ctypes.c_int and argtypes[-1] is ctypes.c_void_p, name
    assert _build._SIGNATURES["tz_gather_staged_words"] == (ctypes.c_int, [])
    assert _build._ARGTYPES["tz_take_along"][-1] is ctypes.c_void_p
