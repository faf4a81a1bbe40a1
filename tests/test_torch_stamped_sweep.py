"""The stamped sweep's device window, on the CPU against a fake card.

A traced sweep runs the kernel's stamped build, which writes its span on
the card (``%globaltimer`` at the first block's start and, from a kernel
that follows it, at its end, nanoseconds) into four words after its
result, and the one
read-back brings them home with the winner. Here the kernel is a fake that
writes known stamps into a real result buffer on the CPU, and the real
``sha256_cuda.sweep_launch`` and ``LaunchedSweep`` run around it:

* ``LaunchedSweep.timing`` turns the stamps into (launched, seconds);
* an untimed sweep keeps its four words and its 8-byte read-back;
* a timed round of the overhead audit and of the pipelined ``Miner``
  reads each sweep once, stamps included, and makes no elapsed-time
  call;
* the ``Miner`` reads a discarded sweep's stamps only once it is done.
"""
import concurrent.futures
import types

import numpy as np
import pytest
import torch

from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
from mpi_blockchain_tpu_torch.blocktrace import overhead
from mpi_blockchain_tpu_torch.config import KernelError, MinerConfig
from mpi_blockchain_tpu_torch.meshwatch import pipeline
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_cuda

DIFFICULTY = 12
#: The fake card's sweeps: the first starts at this %globaltimer reading
#: (past 2^32, so both words of a stamp count), each lasts DEVICE_NS.
T0_NS = (5 << 32) + 123_456_789
DEVICE_NS = 4_000_000


def _reset():
    telemetry.reset()
    telemetry.clear_events()
    telemetry.set_telemetry_disabled(False)
    pipeline.reset_profiler()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _stamp_words(start: int, end: int) -> torch.Tensor:
    """Two uint64 stamps as the four int32 words the kernel leaves."""
    return torch.from_numpy(
        np.array([start, end], dtype=np.uint64).view(np.int32).copy())


def _stamped_buffer(count: int, best: int, start: int,
                    end: int) -> torch.Tensor:
    out = sha256_cuda.new_result(torch.device("cpu"), stamped=True)
    out[0] = count
    out[1] = np.array([best], dtype=np.uint32).view(np.int32)[0].item()
    out[4:] = _stamp_words(start, end)
    return out


class _Event:
    """A completion event on the fake card: done when the card says so."""

    def __init__(self, card):
        self.card, self.done = card, card.done_at_once

    def record(self, stream=None):
        self.card.events.append(self)

    def query(self) -> bool:
        return self.done


class _Card:
    """The fake card behind the real ``sha256_cuda.sweep_launch``: buffers
    on the CPU, a launch that writes known stamps into a stamped buffer
    as the stamped build does, events that are done at once or when
    ``finish`` says, and a count of the read-backs and their words."""

    def __init__(self, monkeypatch, done_at_once: bool = True):
        self.done_at_once = done_at_once
        self.launches: list[tuple[int, int]] = []   # (count, words)
        self.reads: list[int] = []                  # words a read-back
        self.events: list[_Event] = []
        self.elapsed_calls = 0
        cpu = torch.device("cpu")
        read_result = sha256_cuda.read_result

        def launch(ext, base, count, dbits, out, *, early_exit=False):
            if out.shape[0] == sha256_cuda.STAMPED_RESULT_WORDS:
                start = T0_NS + len(self.launches) * DEVICE_NS
                out[4:] = _stamp_words(start, start + DEVICE_NS)
            self.launches.append((count, out.shape[0]))

        def read(out, words=2):
            self.reads.append(words)
            return read_result(out, words)

        def elapsed_time(event, end):
            self.elapsed_calls += 1
            raise AssertionError("an elapsed-time read")

        monkeypatch.setattr(sha256_cuda, "launch", launch)
        monkeypatch.setattr(sha256_cuda, "read_result", read)
        monkeypatch.setattr(
            sha256_cuda, "fresh_result",
            lambda device, stamped=False: sha256_cuda.new_result(cpu,
                                                                 stamped))
        monkeypatch.setattr(torch.cuda.Event, "elapsed_time", elapsed_time)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
        monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(self))

    def finish(self) -> None:
        for event in self.events:
            event.done = True


def _launch(ext=None, count: int = 1 << 10):
    ext = np.zeros(20, dtype=np.uint32) if ext is None else ext
    return sha256_cuda.sweep_launch(ext, 0, count, DIFFICULTY,
                                    device=torch.device("cuda", 0))


def test_timing_turns_the_stamp_words_into_the_window():
    """(launched, (end - start) / 1e9), from both words of each stamp
    (here the sweep crosses a carry into the high word); the result is
    the buffer's first two words, as uint32."""
    start = (5 << 32) + 0xFFFFF000
    end = start + 2_269_400
    assert end >> 32 == 6
    sweep = sha256_cuda.LaunchedSweep(
        _stamped_buffer(3, 0xFFFFFFF0, start, end), event=None,
        launched=12.5)
    assert sweep.timed
    assert sweep.result() == (3, 0xFFFFFFF0)
    assert sweep.timing() == (12.5, 2_269_400 / 1e9)


@pytest.mark.parametrize("stamps", [(2**64 - 1, 0), (T0_NS, 0),
                                    (2**64 - 1, T0_NS)],
                         ids=["none", "no_end", "no_start"])
def test_a_stamp_left_at_its_reset_is_a_kernel_error(stamps):
    """A block that missed an exit path leaves end at 0; one that never
    stamped its entry leaves start all ones."""
    sweep = sha256_cuda.LaunchedSweep(_stamped_buffer(0, 2**32 - 1, *stamps),
                                      event=None, launched=1.0)
    with pytest.raises(KernelError, match="stamps not written"):
        sweep.timing()


def test_a_plain_sweep_has_no_window():
    sweep = sha256_cuda.LaunchedSweep(
        sha256_cuda.new_result(torch.device("cpu")), event=None)
    assert not sweep.timed
    with pytest.raises(ValueError, match="timed_launches"):
        sweep.timing()


def test_the_stamped_buffer_resets_its_stamps():
    """Start all ones and end 0, the identities of the blocks' min and
    max; the four words of a plain buffer stay as they were."""
    cpu = torch.device("cpu")
    assert sha256_cuda.new_result(cpu).tolist() == [0, -1, 0, 0]
    stamped = sha256_cuda.new_result(cpu, stamped=True)
    assert stamped.tolist() == [0, -1, 0, 0, -1, -1, 0, 0]
    assert sha256_cuda.STAMPED_RESULT_WORDS == 8
    sha256_cuda.check_result_buffer(stamped)
    with pytest.raises(ValueError, match="new_result"):
        sha256_cuda.check_result_buffer(torch.zeros(6, dtype=torch.int32))


class _Recorded:
    """A result buffer that records how it is sliced for its read-back."""

    def __init__(self, t: torch.Tensor):
        self.t, self.slices = t, []
        self.shape, self.device, self.is_cuda = t.shape, t.device, False

    def __getitem__(self, index):
        self.slices.append(index)
        return self.t[index]


@pytest.mark.parametrize("stamped", [False, True],
                         ids=["untimed", "stamped"])
def test_a_read_back_is_one_copy_of_the_words_it_needs(stamped):
    """An untimed sweep reads back 2 words, 8 bytes; a stamped one its 8
    words, 32 bytes, in one copy, and its window from them."""
    buf = _Recorded(_stamped_buffer(1, 77, T0_NS, T0_NS + DEVICE_NS)
                    if stamped else
                    torch.tensor([1, 77, 0, 0], dtype=torch.int32))
    sweep = sha256_cuda.LaunchedSweep(buf, event=None, launched=2.0)
    assert sweep.result() == (1, 77)
    if stamped:
        assert sweep.timing() == (2.0, DEVICE_NS / 1e9)
    words = 8 if stamped else 2
    assert buf.slices == [slice(None, words)]
    assert words * buf.t.element_size() == (32 if stamped else 8)


def test_sweep_launch_takes_the_stamped_build_only_when_timed(
        monkeypatch):
    card = _Card(monkeypatch)
    plain = _launch()
    with sha256_cuda.timed_launches():
        stamped = _launch()
        empty = _launch(count=0)
    assert [len(s.out) for s in (plain, stamped, empty)] == [4, 8, 4]
    assert [s.timed for s in (plain, stamped, empty)] == [False, True,
                                                          False]
    assert plain.launched == 0.0 and stamped.launched > 0.0
    # Every sweep carries its one plain completion event.
    assert len(card.events) == 3
    assert card.launches == [(1 << 10, 4), (1 << 10, 8), (0, 4)]
    assert plain.result() == (0, 0xFFFFFFFF)
    assert stamped.result() == (0, 0xFFFFFFFF)
    assert stamped.timing() == (stamped.launched, DEVICE_NS / 1e9)
    assert card.reads == [2, 8] and card.elapsed_calls == 0


@pytest.mark.parametrize("instrumented", [True, False],
                         ids=["instrumented", "off"])
def test_a_timed_audit_round_reads_its_window_from_the_stamps(
        monkeypatch, instrumented):
    """The audit's instrumented round launches the stamped build and takes
    its window from the words of its one read-back; the off round the
    plain build. Neither reads an elapsed time."""
    card = _Card(monkeypatch)
    windows = []
    timing = sha256_cuda.LaunchedSweep.timing

    def recorded(self):
        windows.append(timing(self))
        return windows[-1]

    monkeypatch.setattr(sha256_cuda.LaunchedSweep, "timing", recorded)
    sweep = overhead._sweep_fn("cuda:0")
    prev = telemetry.set_telemetry_disabled(not instrumented)
    try:
        assert sweep(5, 1 << 10) == (0, 0xFFFFFFFF)
    finally:
        telemetry.set_telemetry_disabled(prev)
    words = 8 if instrumented else 4
    assert card.launches == [(1 << 10, words)]
    assert card.reads == [8 if instrumented else 2]
    assert [w[1] for w in windows] == (
        [DEVICE_NS / 1e9] if instrumented else [])
    assert card.elapsed_calls == 0


class _Dispatch(concurrent.futures.Future):
    """The resilient backend's future in form: resolved when asked, on the
    C++ sweep, after the read-back of its sweep on the fake card."""

    def __init__(self, fn, sweep, card):
        super().__init__()
        self.fn, self.sweep, self.card = fn, sweep, card
        self.from_launch = False

    def result(self, timeout=None):
        if not self.done():
            self.card.finish()
            self.sweep.result()
            self.set_result(self.fn())
            self.from_launch = True
        return super().result(timeout)


class _StampedBackend(CpuBackend):
    """The C++ sweep for the answers, a real ``LaunchedSweep`` on the fake
    card for each search's window."""

    def __init__(self, card):
        super().__init__()
        self.card = card
        self.sweeps: list[sha256_cuda.LaunchedSweep] = []

    def search_async(self, header80, difficulty_bits, start_nonce=0,
                     max_count=1 << 32):
        self.sweeps.append(_launch())
        return _Dispatch(lambda: self.search(
            header80, difficulty_bits, start_nonce=start_nonce,
            max_count=max_count), self.sweeps[-1], self.card)


def _device_windows() -> list[tuple[float, float]]:
    anchor = pipeline.profiler().at(0.0)
    return sorted((s["t0"] - anchor, s["t1"] - anchor)
                  for r in pipeline.profiler().records()
                  for s in r["segments"] if s["stage"] == "device")


def test_a_traced_miner_takes_each_window_from_one_read_back(monkeypatch):
    """The pipelined ``Miner`` with its telemetry on: every sweep is the
    stamped build, read back once (8 words: its result and its stamps),
    and its window lasts its stamps' span; no elapsed-time read."""
    card = _Card(monkeypatch, done_at_once=False)
    backend = _StampedBackend(card)
    miner = Miner(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=4,
                              backend="cpu"), backend=backend, pipeline=True)
    miner.mine_chain()
    sweeps = backend.sweeps
    assert sweeps and all(s.timed for s in sweeps)
    assert card.reads == [8] * len(sweeps) and card.elapsed_calls == 0
    windows = _device_windows()
    assert len(windows) == len(sweeps)
    for t0, t1 in windows:
        assert t1 - t0 == pytest.approx(DEVICE_NS / 1e9, abs=1e-6)


def test_an_untraced_miner_reads_8_bytes_a_sweep(monkeypatch):
    card = _Card(monkeypatch, done_at_once=False)
    backend = _StampedBackend(card)
    telemetry.set_telemetry_disabled(True)
    miner = Miner(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=3,
                              backend="cpu"), backend=backend, pipeline=True)
    miner.mine_chain()
    assert backend.sweeps and not any(s.timed for s in backend.sweeps)
    assert card.reads == [2] * len(backend.sweeps)
    assert pipeline.profiler().records() == []


def test_drain_reads_a_discarded_window_only_once_it_is_done(monkeypatch):
    """A discarded sweep still on the card is left for a later drain, its
    buffer unread; once its event is done, one read-back of its 8 words
    gives its window, as unattributed work."""
    card = _Card(monkeypatch, done_at_once=False)
    miner = Miner(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=1,
                              backend="cpu"), pipeline=True)
    with sha256_cuda.timed_launches():
        sweep = _launch()
    prec = pipeline.profiler().dispatch(kind="sweep", height=1,
                                        backend="cpu")
    d = types.SimpleNamespace(future=types.SimpleNamespace(sweep=sweep),
                              prec=prec, t_issue=0.0)
    miner._draining = [d]
    miner._drain_card()
    assert miner._draining == [d] and card.reads == []
    assert _device_windows() == []
    card.finish()
    miner._drain_card()
    assert miner._draining == [] and card.reads == [8]
    (t0, t1), = _device_windows()
    assert t1 - t0 == pytest.approx(DEVICE_NS / 1e9, abs=1e-6)
    assert card.elapsed_calls == 0


def test_stamp_variants_patch_the_current_source(monkeypatch):
    """Every variant of ``tools/stamp_variants.py`` still applies to the
    shipped source; those that stamp the end in the sweep drop the kernel
    that follows it."""
    from mpi_blockchain_tpu_torch.tools import stamp_variants
    source = sha256_cuda.SOURCE.read_text()
    assert stamp_variants.variant_source("shipped") == source
    launch_end = "sweep_end_stamp_kernel<<<"
    assert launch_end in source
    for name in stamp_variants.VARIANTS:
        if name == "shipped":
            continue
        text = stamp_variants.variant_source(name)
        assert text != source
        assert launch_end not in text
        assert "atomicMax(" in text
    monkeypatch.setitem(stamp_variants.VARIANTS, "stale",
                        [("no such text", "")])
    with pytest.raises(ValueError, match="0 times"):
        stamp_variants.variant_source("stale")
