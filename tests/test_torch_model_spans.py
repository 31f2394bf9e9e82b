"""The model path's spans and MoE counters (``mpi.trace.model_span``,
``model_on``, ``MODEL_COUNTERS``) on the CPU, at the port's small test
config (vocab 128, d_model 64, 4 heads, 2 layers, d_ff 128, seq 32, f32;
the MoE family with 8 experts):

- off (no profiler recording, the timeline disarmed) a train step and a
  greedy decode call open no ``record_function``, write no ring span and
  move no counter;
- under a CPU ``torch.profiler`` a step is ``ompi.train.step`` holding
  ``.forward``, ``.backward`` and ``.optimizer``, each batch drawn one
  ``ompi.data.wait`` outside it; ``ompi.attention`` and ``ompi.moe`` once
  a layer a forward and once more a remat recompute; a decode call one
  ``ompi.decode.prefill``, ``max_new − 1`` ``ompi.decode.step`` and a
  ``ompi.decode.attend`` a layer a step;
- with the timeline armed the same spans land in the ring under
  ``model``: the step's with its number and its phases inside it, the
  decode's with their call and position;
- the counters count what ``moe.recording()`` records over the same
  calls; a read of a device sum never waits for the device: it takes
  the newest total whose copy has finished (and, on a card, a sum
  queued behind a long kernel is read at once, then in full after a
  synchronize);
- a span recorded both ways lands on the profiler's clock within 1 ms of
  itself once ``tools/trace_export.py --onto`` lays the ring's dump onto
  the profiler's trace.
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.models.data import ArraySource, train_stream
from ompi_tpu_torch.models.decode import make_decoder
from ompi_tpu_torch.models.weights import from_jax_params
from ompi_tpu_torch.mpi import trace
from ompi_tpu_torch.parallel import moe
from ompi_tpu_torch.parallel.mesh import make_mesh
from ompi_tpu_torch.tools import trace_export

FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=32, attention="flash", compute_dtype="float32")
L = FIELDS["n_layers"]
BATCH = 4
MAX_NEW = 5
TRAIN = ("ompi.train.step", "ompi.train.forward", "ompi.train.backward",
         "ompi.train.optimizer")


def _cfg(experts: int = 0, remat="dots") -> T.TransformerConfig:
    return T.TransformerConfig(**FIELDS, moe_experts=experts, remat=remat)


def _mesh():
    return make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")


class _Trainer:
    """A training state and its prefetched stream at the small config."""

    def __init__(self, experts: int, remat):
        self.experts, self.remat = experts, remat
        cfg = _cfg(experts, remat)
        mesh = _mesh()
        self.params = from_jax_params(T.init_params(cfg, 0), cfg, "cpu",
                                      train=True)
        self.step, init = T.make_train_step(cfg, mesh, lr=1e-3)
        self.opt = init(self.params)
        corpus = (np.arange(4096) * 2654435761 % cfg.vocab).astype(np.int32)
        self.stream = train_stream(ArraySource(corpus, 1), mesh, BATCH,
                                   cfg.seq)

    def __call__(self, n: int = 1) -> None:
        for _ in range(n):
            self.params, self.opt, _ = self.step(self.params, self.opt,
                                                 next(self.stream))


@pytest.fixture
def trainer(request):
    t = _Trainer(*request.param)
    t()                       # the first step outside every window
    yield t
    t.stream.close()


def _decoder(experts: int = 0):
    cfg = _cfg(experts)
    params = from_jax_params(T.init_params(cfg, 0), cfg, "cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, 8))
    decode = make_decoder(cfg, _mesh(), MAX_NEW)
    return lambda: decode(params, prompt)


def _spans(prof, tmp_path) -> list:
    """[(name, thread, start µs, end µs)] of the profile's ``ompi.*``
    spans, in start order."""
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    out = [(e["name"], e["tid"], float(e["ts"]), float(e["ts"] + e["dur"]))
           for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith("ompi.")]
    return sorted(out, key=lambda s: s[2])


def _within(inner, outer) -> bool:
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _model_counters() -> dict:
    snap = trace.counters_snapshot()
    return {k: snap[k] for k in trace.MODEL_COUNTERS}


@pytest.fixture
def armed():
    """The timeline armed for the test, disarmed after it."""
    assert not trace.active
    rec = trace.enable(capacity=1 << 16)
    try:
        yield rec
    finally:
        trace.disable()


@pytest.mark.parametrize("trainer", [(8, "dots")], indirect=True)
def test_off_records_nothing(trainer, monkeypatch):
    assert not trace.active and not trace.model_on()
    assert trace.model_span("x", step=1) is trace.model_span("y")

    def refuse(*_a, **_k):
        raise AssertionError("a model span was opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_model_span", refuse)
    before = _model_counters()
    trainer(2)
    _decoder(8)()
    assert _model_counters() == before


@pytest.mark.parametrize("trainer", [(0, False), (0, "dots"), (8, "dots")],
                         indirect=True)
def test_train_spans_under_a_profiler(trainer, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer(2)
    spans = _spans(prof, tmp_path)
    got = collections.Counter(s[0] for s in spans)
    calls = 2 * L * (2 if trainer.remat else 1)   # forward + recompute
    assert got["ompi.data.wait"] == 2
    for name in TRAIN:
        assert got[name] == 2, name
    assert got["ompi.attention"] == calls
    assert got["ompi.moe"] == (calls if trainer.experts else 0)
    steps = [s for s in spans if s[0] == "ompi.train.step"]
    for s in spans:
        inside = any(_within(s, st) for st in steps if st is not s)
        assert inside == (s[0] != "ompi.train.step"
                          and s[0] != "ompi.data.wait"), s


def test_decode_spans_under_a_profiler(tmp_path):
    decode = _decoder()
    decode()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode()
    spans = _spans(prof, tmp_path)
    got = collections.Counter(s[0] for s in spans)
    assert got["ompi.decode.prefill"] == 1
    assert got["ompi.decode.step"] == MAX_NEW - 1
    assert got["ompi.decode.attend"] == (MAX_NEW - 1) * L
    assert got["ompi.attention"] == L         # the prefill's, a layer
    steps = [s for s in spans if s[0] == "ompi.decode.step"]
    (prefill,) = [s for s in spans if s[0] == "ompi.decode.prefill"]
    for s in spans:
        if s[0] == "ompi.decode.attend":
            assert sum(_within(s, st) for st in steps) == 1, s
        if s[0] == "ompi.attention":
            assert _within(s, prefill), s


@pytest.mark.parametrize("trainer", [(8, "dots")], indirect=True)
def test_ring_spans_carry_their_step_call_and_position(trainer, armed):
    trainer(2)
    _decoder()()
    model = [e for e in armed.snapshot() if e[2] == "model"]
    by_name = collections.defaultdict(list)
    for ts, dur, _cat, name, _rank, args in model:
        assert dur is not None and dur >= 0
        by_name[name].append(args or {})
    # the fixture's first step was number 0; a step's phases carry no
    # number of their own: each lies inside its step's span
    assert [a["step"] for a in by_name["train.step"]] == [1, 2]
    steps = [(ts, ts + dur) for ts, dur, _c, name, _r, _a in model
             if name == "train.step"]
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert by_name[name] == [{}, {}], name
        inside = [sum(s <= ts and ts + dur <= e for s, e in steps)
                  for ts, dur, _c, n, _r, _a in model if n == name]
        assert inside == [1, 1], name
    assert len(by_name["data.wait"]) == 2
    assert len(by_name["attention"]) == 2 * 2 * L + L
    assert len(by_name["moe"]) == 2 * 2 * L
    assert by_name["decode.prefill"] == [{"call": 0}]
    prompt = 8
    assert by_name["decode.step"] == [
        {"call": 0, "pos": p} for p in range(prompt, prompt + MAX_NEW - 1)]
    assert [a["pos"] for a in by_name["decode.attend"]] == [
        p for p in range(prompt, prompt + MAX_NEW - 1) for _ in range(L)]
    tid = trace.CATEGORIES.index("model")
    assert {e["tid"] for e in trace.chrome_events(armed)
            if e["cat"] == "model"} == {tid}


@pytest.mark.parametrize("trainer", [(8, "dots")], indirect=True)
def test_moe_counters_count_what_recording_records(trainer):
    before = _model_counters()
    with profile(activities=[ProfilerActivity.CPU]), \
            moe.recording() as records:
        trainer(2)
    after = _model_counters()
    # a host tensor's count is an int at once; only a card's is summed
    # on the device
    for name in trace.MODEL_COUNTERS:
        assert isinstance(trace.counters[name], int), name
    assert len(records) == 2 * 2 * L      # forward and recompute
    routed = sum(r["tokens"] for r in records)
    dropped = int(sum(int(r["dropped"]) for r in records))
    assert routed == 2 * 2 * L * BATCH * FIELDS["seq"]
    assert after["moe_tokens_routed_total"] - before[
        "moe_tokens_routed_total"] == routed
    assert after["moe_tokens_dropped_total"] - before[
        "moe_tokens_dropped_total"] == dropped > 0
    text = trace.metrics_snapshot()
    for name in trace.MODEL_COUNTERS:
        assert f"ompi_tpu_{name} {after[name]}\n" in text


def test_a_ring_span_lands_on_the_profilers_clock(tmp_path, armed):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.model_span("probe", step=7):
            time.sleep(0.005)
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    dump = trace.flush(str(tmp_path / "ompi_tpu_trace_0_rank0.json"))
    doc = trace_export.onto_profile(
        json.loads((tmp_path / "profile.json").read_text()), [dump])
    (mine,) = [e for e in doc["traceEvents"] if e.get("name") == "ompi.probe"
               and e.get("cat") == "user_annotation"]
    (ring,) = [e for e in doc["traceEvents"] if e.get("name") == "probe"
               and e.get("cat") == "model"]
    assert ring["pid"] == trace_export.ONTO_PID_BASE + armed.rank
    assert ring["args"] == {"step": 7}
    assert abs(ring["ts"] - mine["ts"]) < 1000
    assert abs(ring["dur"] - mine["dur"]) < 1000
    out = tmp_path / "both.json"
    assert trace_export.main(["--onto", str(tmp_path / "profile.json"),
                              "-o", str(out), dump]) == 0
    assert json.loads(out.read_text())["traceEvents"] == json.loads(
        json.dumps(doc["traceEvents"]))


class _Event:
    """A device event the device has not passed yet, or one that fails
    (a sticky device error)."""

    def __init__(self):
        self.done, self.error = False, None

    def query(self):
        if self.error is not None:
            raise self.error
        return self.done


class _HostCopy:
    """The pinned copy of a device total: reading it before its event has
    passed would read a copy still in flight, or, were it the device
    tensor, wait for the stream."""

    def __init__(self, event, value):
        self.event, self.value = event, value

    def __int__(self):
        if not self.event.done or self.event.error is not None:
            raise AssertionError("a read waited for the device")
        return self.value


def test_a_read_never_waits_for_a_device_sum(tmp_path, armed, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    name = "moe_tokens_dropped_total"
    event = _Event()
    monkeypatch.setitem(trace._device_sums, name,
                        trace._DeviceSum(None, _HostCopy(event, 5), event))
    base = trace.counters[name]

    def reads() -> list:
        dump = json.loads(open(trace.crash_dump("test")).read())
        return [trace.counters_snapshot()[name],
                dump["otherData"]["counters"][name],
                trace.metrics_values()[name]]

    assert reads() == [base] * 3                # the copy not yet finished
    event.done = True
    assert reads() == [base + 5] * 3
    event.error = RuntimeError("a sticky device error")
    assert reads() == [base + 5] * 3            # the last total stands


@pytest.mark.gpu
def test_a_card_sum_is_read_without_waiting():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sum lives on the device)")
    ds = trace._DeviceSum.like(torch.zeros((), device="cuda"))
    ds.add(torch.tensor(3, device="cuda"))
    # made, and every kernel loaded, before the sleep: a kernel's first
    # load could wait for the sleep to end
    seven = torch.ones(7, dtype=torch.int64, device="cuda").sum()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    assert ds.read() == 3
    torch.cuda._sleep(2_000_000_000)            # ~1 s of one busy SM
    ds.add(seven)
    t0 = time.perf_counter()
    assert ds.read() == 3                       # behind the sleep: not yet
    assert time.perf_counter() - t0 < 0.1
    torch.cuda.synchronize()
    assert ds.read() == 10
