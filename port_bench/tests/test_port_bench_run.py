"""Runs of every cell at a tiny size on the port's CPU paths: a sound run is
correct, the lower-precision control is not, and each fault a cell can have,
planted under the harness, turns ``correct`` false. These print no device
metric; timing and the card's numbers come only from a run on the card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, tiny_cell
from port_bench import harness

CPU = torch.device("cpu")
WORKLOADS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 12345  # beyond 32 signed bits, as a run's seed may be


def _run(bench, workload, entry_cls=None, traced=False):
    cell = tiny_cell(bench, workload)
    return harness.run_cell(cell, SEED, 0.2, traced, CPU, time.perf_counter(),
                            entry_cls=entry_cls)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_tiny_run_is_correct(bench, workload, traced):
    result = _run(bench, workload, traced=traced)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    check = result["checks"]["rel_err"]
    assert 0 < check["value"] < check["limit"]
    cell = harness.find_cell(bench, workload)
    wanted = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    # no device trace on the CPU: only the host's readings
    assert set(result["metrics"]) <= wanted
    assert ("host_ms_per_call" in result["metrics"]) == traced
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_same_seed_same_inputs(bench, workload):
    cell = tiny_cell(bench, workload)
    cls = harness.entry_class(cell.traffic)
    a = cls(cell.config, cell.traffic, SEED, CPU)
    b = cls(cell.config, cell.traffic, SEED, CPU)
    c = cls(cell.config, cell.traffic, SEED + 1, CPU)
    assert torch.equal(a.bank, b.bank) and torch.equal(a.pool, b.pool)
    assert not torch.equal(a.pool, c.pool)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(bench, workload):
    """The reference with bfloat16 operands and result, in the program's
    place, reads over the limit (on the card at full size: PERF.md)."""
    cell = tiny_cell(bench, workload)
    entry = harness.entry_class(cell.traffic)(cell.config, cell.traffic, SEED, CPU)
    kept = {k: entry.call(k) for k in range(2)}
    _, sound_failed = harness.check_answers(entry, kept, cell.traffic["limits"])
    control, failed = harness.check_answers(entry, kept, cell.traffic["limits"], "bfloat16")
    assert sound_failed == 0 and failed == len(kept)
    assert control["rel_err"]["value"] > 10 * control["rel_err"]["limit"]


@pytest.mark.parametrize("period", [None, 0.05], ids=["closed_loop", "open_loop"])
def test_window_records_every_call(bench, period):
    """Each call's due and dispatch times, its start and end and its span;
    open loop (``period_s`` in the traffic) dispatches call j at j·period,
    closed loop as soon as the last returns. The kept answers are copies in
    the slots made before the window, not the program's own tensors."""
    cell = tiny_cell(bench, WORKLOADS[0])
    if period:
        cell.traffic["period_s"] = period
    entry = harness.entry_class(cell.traffic)(cell.config, cell.traffic, SEED, CPU)
    t_call, answer = harness.warm_up(entry, cell.traffic, CPU)
    offsets = {0, 2}
    slots = harness.slots_for(offsets, answer)
    ptrs = {t.data_ptr() for t in slots}
    run = harness.Run(setup_s=0.0)
    k0 = int(cell.traffic["warmup_calls"])
    kept, k = entry.window(k0, 0.3, offsets, slots, run)
    n = run.calls
    assert n == k - k0 >= 3 and not slots
    for name in ("due_s", "dispatch_s", "enqueue_s", "start_s", "done_s", "call_s"):
        assert len(getattr(run, name)) == n, name
    assert all(d >= u for d, u in zip(run.dispatch_s, run.due_s))
    assert all(s <= e for s, e in zip(run.start_s, run.done_s))
    if period:
        assert run.due_s == pytest.approx([j * period for j in range(n)])
        assert n <= round(0.3 / period) + 1
    else:
        assert run.due_s == run.dispatch_s
    assert {kept[k0].data_ptr(), kept[k0 + 2].data_ptr()} == ptrs and k - 1 in kept
    _, failed = harness.check_answers(entry, kept, cell.traffic["limits"])
    assert failed == 0


def test_traffic_leaves_the_deployment_to_its_configuration(bench):
    """A traffic file states no key its configuration states (the sample
    rate, say), so the two cannot disagree."""
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert not set(cell.traffic) & set(cell.config), w["name"]


def _faulty(cls, fault):
    class Faulty(cls):
        def call(self, k):
            out = super().call(k)
            if fault == "half_batch":  # half of the channels left out
                out = out.clone()
                out[out.shape[0] // 2:] = 0
            elif fault == "answer_altered":  # one sample changed where it is made
                out = out.clone()
                out[0, out.shape[-1] // 3] += out[0].abs().max()
            return out

        def _process(self, state, x):  # the stream step returns its state unchanged
            new_state, y = super()._process(state, x)
            return (state if fault == "state_unchanged" else new_state), y
    return Faulty


FAULTS = [(w, f) for w in WORKLOADS for f in ("half_batch", "answer_altered")]
FAULTS += [(w, "state_unchanged") for w in WORKLOADS
           if harness.find_cell(harness.load_json(ROOT / "BENCHMARK.json"),
                                w).traffic["entry"] == "convolver_stream"]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f}" for w, f in FAULTS])
def test_fault_is_not_correct(bench, workload, fault):
    cell = tiny_cell(bench, workload)
    result = _run(bench, workload, entry_cls=_faulty(harness.entry_class(cell.traffic), fault))
    assert result["correct"] is False and result["failed"] >= 1


def test_no_card_no_result():
    """Without a card the command exits with another code than 0 and prints
    nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_on_the_card():
    """One short run of the first cell on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", WORKLOADS[0],
                          "--seed", str(SEED), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
