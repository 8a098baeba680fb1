"""The port's compute plane (``fedml_tpu_torch/core/obs/roofline.py``)
against hand counts, the JAX module's per-op rules and the records'
consumers, on the CPU.

The JAX module walks XLA's HLO, the port's captures eager aten ops (its
own design; the module docstring says why), so the two are held to each
other op by op: for the same shapes, the port's FLOPs and bytes of an
aten op equal the JAX module's ``_op_flops`` / ``_op_bytes`` of the HLO op
XLA would emit. Then: hand counts, ``mult`` from a program's steps, the
balance table, the default knobs, recompile forensics (tracker and the
engine's seam), the serving seam's captures, a kernel row reported
through ``count_launch``, the records against the schema copy, a capture
leaving its program as it was, the FLOPs of the registry ops equal to
``FlopCounterMode``'s, and ``scripts/roofline_report.py`` rendering the
port's JSONL.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from fedml_tpu.core.obs import roofline as jroof
from fedml_tpu_torch.core.algframe.types import TrainHyper
from fedml_tpu_torch.core.obs import roofline, schema, sink

from torch_port_support import port_sim, single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

LR = dict(dataset="synthetic_mnist", model="lr", client_num_in_total=4,
          client_num_per_round=4, comm_round=2, epochs=1, batch_size=16,
          learning_rate=0.1, frequency_of_the_test=100, random_seed=0,
          max_total_samples=256)


@pytest.fixture
def records():
    recs = []
    sink.set_sink(recs.append)
    yield recs
    sink.set_sink(None)


def _one(fn, *args):
    rows = roofline.capture_rows(fn, args)
    assert len(rows) == 1, [r.name for r in rows]
    return rows[0]


# --- hand counts ------------------------------------------------------------

def test_matmul_flops_and_bytes_exact():
    """2·M·N·K flops, operands + output bytes: the JAX module's hand
    check on the port."""
    rec = roofline.analyze("mm", lambda a, b: a @ b,
                           (torch.ones(8, 16), torch.ones(16, 4)))
    assert rec["total_flops"] == 2 * 8 * 16 * 4
    assert rec["total_bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    top = rec["ops"][0]
    assert top["op"] == "mm"
    assert top["operands"] == ["f32[8,16]", "f32[16,4]"]
    assert rec["attributed_share"] == 1.0
    assert top["bound"] == "memory"
    assert rec["collectives"] == [] and rec["collective_wire_bytes"] == 0.0
    assert rec["xla_flops"] is None and rec["xla_bytes"] is None


@pytest.mark.parametrize("fn,args,flops,nbytes", [
    # a 3x3 conv, 2 -> 5 channels on 6x6, padding 1: 2·out·9·cin
    (lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
     (torch.ones(1, 2, 6, 6), torch.ones(5, 2, 3, 3)),
     2 * (5 * 36) * 9 * 2, 4 * (72 + 90 + 180)),
    # elementwise: its output's elements, read both + write
    (lambda a, b: a + b, (torch.ones(10, 3), torch.ones(10, 3)),
     30, 4 * 90),
    # a reduction: its input's elements
    (lambda a: a.sum(dim=0), (torch.ones(10, 3),), 30, 4 * 33),
    # a window read: twice its output, whatever the operand's size
    (lambda a, i: torch.index_select(a, 0, i),
     (torch.ones(100, 4), torch.tensor([3, 7])), 0, 2 * 4 * 8),
    # a window write: twice the update
    (lambda a, i, v: a.index_put_((i,), v),
     (torch.zeros(100, 4), torch.tensor([3, 7]), torch.ones(2, 4)),
     0, 2 * 4 * 8),
    # sort: n·log2 n
    (lambda a: torch.sort(a).values, (torch.ones(64),), 64 * 6,
     4 * 64 * 2 + 8 * 64),
])
def test_hand_counts(fn, args, flops, nbytes):
    r = _one(fn, *args)
    assert (r.flops, r.bytes, r.known) == (flops, nbytes, True)


def test_views_and_empty_cost_nothing():
    rows = roofline.capture_rows(
        lambda a: (a.view(4, 4).t().unsqueeze(0), torch.empty(3)),
        (torch.ones(16),))
    assert rows == []


def test_unknown_op_is_estimated():
    rows = roofline.capture_rows(lambda a: torch.fft.fft(a),
                                 (torch.ones(8),))
    assert rows and all(r.estimated and not r.known for r in rows)
    rec = roofline.record_from_rows("fft", rows)
    assert rec["attributed_share"] < 1.0


# --- the JAX module's per-op rules -----------------------------------------

def _hlo(opcode, out, operands, attrs=""):
    return jroof.HloOp(name=f"{opcode}.1", opcode=opcode, out_shapes=out,
                       operand_shapes=operands, attrs=attrs)


@pytest.mark.parametrize("case", [
    "dot", "convolution", "add", "multiply", "reduce", "dynamic-slice",
    "dynamic-update-slice", "sort", "copy"])
def test_per_op_rules_equal_the_jax_module(case):
    """The same shapes through the port's capture and through the JAX
    module's ``_op_flops`` / ``_op_bytes``: equal FLOPs and bytes."""
    f32 = "f32"
    if case == "dot":
        fn, args = (lambda a, b: a @ b), (torch.ones(8, 16),
                                          torch.ones(16, 4))
        op = _hlo("dot", [(f32, (8, 4))], [(f32, (8, 16)), (f32, (16, 4))],
                  "lhs_contracting_dims={1}, rhs_contracting_dims={0}")
    elif case == "convolution":
        fn = lambda x, w: torch.nn.functional.conv2d(x, w,  # noqa: E731
                                                     padding=1)
        args = (torch.ones(2, 3, 6, 6), torch.ones(4, 3, 3, 3))
        op = _hlo("convolution", [(f32, (2, 6, 6, 4))],
                  [(f32, (2, 6, 6, 3)), (f32, (3, 3, 3, 4))],
                  "window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f")
    elif case in ("add", "multiply"):
        fn = (lambda a, b: a + b) if case == "add" else (lambda a, b: a * b)
        args = (torch.ones(7, 5), torch.ones(7, 5))
        op = _hlo(case, [(f32, (7, 5))], [(f32, (7, 5))] * 2)
    elif case == "reduce":
        fn, args = (lambda a: a.sum(dim=1)), (torch.ones(7, 5),)
        op = _hlo("reduce", [(f32, (7,))], [(f32, (7, 5))])
    elif case == "dynamic-slice":
        fn = lambda a, i: torch.index_select(a, 0, i)  # noqa: E731
        args = (torch.ones(64, 256), torch.tensor([3]))
        op = _hlo("dynamic-slice", [(f32, (1, 256))], [(f32, (64, 256))])
    elif case == "dynamic-update-slice":
        fn = lambda a, i, v: a.index_put_((i,), v)  # noqa: E731
        args = (torch.zeros(64, 256), torch.tensor([3]),
                torch.ones(1, 256))
        op = _hlo("dynamic-update-slice", [(f32, (64, 256))],
                  [(f32, (64, 256)), (f32, (1, 256))])
    elif case == "sort":
        fn, args = (lambda a: torch.sort(a).values), (torch.ones(64),)
        op = _hlo("sort", [(f32, (64,))], [(f32, (64,))])
    else:
        fn, args = (lambda a: a.clone()), (torch.ones(9, 9),)
        op = _hlo("copy", [(f32, (9, 9))], [(f32, (9, 9))])
    rows = roofline.capture_rows(fn, args)
    jflops, known = jroof._op_flops(op, {}, {})
    assert known
    assert sum(r.flops for r in rows) == jflops
    if case == "sort":
        # torch.sort also writes its int64 indices (XLA's sort here
        # returns the values only)
        assert rows[0].bytes - 8 * 64 == jroof._op_bytes(op)
    else:
        assert sum(r.bytes for r in rows) == jroof._op_bytes(op)


# --- the machine balance ----------------------------------------------------

def test_machine_balance_table():
    """Each NVIDIA card of the profiler's peak table has a bandwidth; the
    CPU's balance is nominal and static-only; an H100 SXM's is 989 TFLOP/s
    over 3,350 GB/s; no TPU kind has one."""
    from fedml_tpu_torch.core.obs import profiler
    for key, _peak in profiler.PEAK_TFLOPS_BF16:
        if key.startswith("h100") or key == "cpu":
            assert roofline.hbm_gbps(key) is not None, key
        else:
            assert roofline.hbm_gbps(key) is None, key
    cpu = roofline.machine_balance("cpu")
    assert cpu.static_only and cpu.flops_per_byte is not None
    h100 = roofline.machine_balance("NVIDIA H100 80GB HBM3")
    assert not h100.static_only
    assert (h100.peak_tflops, h100.hbm_gbps) == (989.0, 3350.0)
    assert h100.flops_per_byte == pytest.approx(989e12 / 3350e9)
    pcie = roofline.machine_balance("NVIDIA H100 PCIe")
    assert (pcie.peak_tflops, pcie.hbm_gbps) == (756.0, 2000.0)


# --- the engine's seam ------------------------------------------------------

def test_engine_run_records_mult_from_steps_and_validates(tmp_path):
    """``obs_roofline``: one record per (program, signature) through the
    run's JSONL, schema-valid, its rows multiplied by the steps the round
    ran, and the params of a run with the knob off, bitwise."""
    from fedml_tpu_torch.core import mlops
    from fedml_tpu_torch.arguments import Arguments
    mlops.init(Arguments(log_file_dir=str(tmp_path), run_id="roof"))
    try:
        sim = port_sim(dict(LR, obs_roofline=True))
        hyper = TrainHyper(learning_rate=0.1, epochs=1)
        sim.run_round(0, hyper)
        steps = sum(p.steps for p in sim.programs.values())
        sim.run_round(1, hyper)
    finally:
        mlops.init(Arguments(enable_tracking=False))
    rep = roofline.report("round")
    assert rep["static_only"] is True and rep["attributed_share"] == 1.0
    assert {o["mult"] for o in rep["ops"]} == {steps}
    assert rep["total_flops"] > 0 and rep["predicted_mfu"] is not None
    lines = []
    for p in glob.glob(str(tmp_path / "**" / "*.jsonl"), recursive=True):
        with open(p) as f:
            lines += f.readlines()
    assert schema.validate_lines(lines) == []
    kinds = [json.loads(ln)["kind"] for ln in lines if ln.strip()]
    assert kinds.count("roofline") == 1       # the second round: same sig
    off = port_sim(LR)
    assert off._roofline.enabled is False
    off.run_round(0, hyper)
    off.run_round(1, hyper)
    for k, v in off.params.items():
        assert torch.equal(v, sim.params[k]), k
    from fedml_tpu_torch.core.obs.metrics import REGISTRY
    g = REGISTRY.gauge("roofline_predicted_mfu", labels=("program",))
    assert g.value(program="round") is not None


def test_async_engine_pours_through_the_seam(records):
    """The buffered-async engine's pours dispatch through the same seam:
    one record for ``async_pour``, its rows multiplied by the steps the
    pour's cohort ran."""
    sim = port_sim(dict(LR, round_mode="async_buffered", async_buffer_k=2,
                        client_num_in_total=6, obs_roofline=True))
    res = sim.run(3)
    assert len(res["history"]) == 3
    rec = [r for r in records if r["kind"] == "roofline"]
    assert [r["program"] for r in rec] == ["async_pour"]
    assert rec[0]["total_flops"] > 0 and schema.validate_record(rec[0]) == []


def test_default_knobs_capture_nothing(records):
    sim = port_sim(LR)
    sim.run_round(0, TrainHyper(learning_rate=0.1, epochs=1))
    assert not [r for r in records if r["kind"] in ("roofline",
                                                   "recompile")]


def _rebatch(sim, bs):
    """The engine's training data re-batched to ``bs`` samples a batch
    (the same samples, in order): a new batch width."""
    from fedml_tpu_torch.core.algframe.local_training import batch_real_of
    from fedml_tpu_torch.core.algframe.types import ClientData
    t = sim.train
    c = t.x.shape[0]

    def re(a):
        return a.reshape((c, -1, bs) + tuple(a.shape[3:]))
    sim.train = ClientData(re(t.x), re(t.y), re(t.mask), t.num_samples)
    sim.batch_real = batch_real_of(sim.train.mask.cpu().numpy())


def test_engine_seam_forensics_on_width_change(records):
    """A round at a new batch width builds a new step program: the
    ``recompile`` record names the data leaves that moved, and nothing
    before it emitted one."""
    sim = port_sim(LR)
    hyper = TrainHyper(learning_rate=0.1, epochs=1)
    sim.run_round(0, hyper)
    sim.run_round(1, hyper)
    assert not [r for r in records if r["kind"] == "recompile"]
    _rebatch(sim, 8)
    sim.run_round(2, hyper)
    fore = [r for r in records if r["kind"] == "recompile"]
    assert len(fore) == 1
    rec = fore[0]
    assert rec["program"] == "round" and rec["compiles"] == 1
    changed = {c["arg"]: (c["was"], c["now"]) for c in rec["changed"]}
    assert changed["['train']['x']"][0].endswith(",16,784]")
    assert changed["['train']['x']"][1].endswith(",8,784]")
    assert schema.validate_record(rec) == []
    assert roofline.recent_recompiles()[-1]["changed"] == rec["changed"]


def test_forced_recompile_names_the_changed_shape(records):
    tracker = roofline.DispatchTracker(enabled=False)
    recs = []
    for shape in ((4,), (8,)):
        sig = roofline.dispatch_signature((torch.zeros(shape),))
        recs.append(tracker.observe("prog", sig, 1))
    assert recs[0] is None
    ch = recs[1]["changed"][0]
    assert ch["arg"] == "[0]"
    assert (ch["was"], ch["now"]) == ("float32[4]", "float32[8]")
    assert schema.validate_record(
        {**recs[1], "kind": "recompile", "ts": 0.0, "run_id": "t"}) == []
    # no build, no record
    assert tracker.observe("prog", sig, 0) is None


def test_dispatch_signature_equals_the_jax_module():
    """On the same tree of arrays: the JAX module's paths and shapes
    (``jax.tree_util`` order and ``keystr`` paths), the structure's
    paths computed once."""
    tree = {"b": np.zeros((2, 3), np.float32),
            "a": [np.ones(4, np.int32), (np.zeros(1, np.float32), 7)]}
    assert roofline.dispatch_signature(tree) == jroof.dispatch_signature(
        tree)
    n = len(roofline._path_cache)
    roofline.dispatch_signature(tree)
    assert len(roofline._path_cache) == n


# --- the serving seam -------------------------------------------------------

def test_decode_and_prefill_programs_capture():
    """``DecodeScheduler(roofline=True)``: the decode step and the prefill
    chunk are captured once per (program, signature), not once per
    token, and the scheduler's tokens are those of one without it."""
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.llm.federated import build_llm_bundle
    from fedml_tpu_torch.serving.batch import DecodeScheduler
    args = Arguments(
        dataset="llm_synthetic", model="causal_lm", client_num_in_total=2,
        client_num_per_round=2, comm_round=1, epochs=1, batch_size=4,
        learning_rate=1e-3, random_seed=3, llm_hidden_size=32,
        llm_num_layers=2, llm_num_heads=2, llm_intermediate_size=64,
        llm_max_seq_len=64, lora_rank=4, llm_attention_impl="dense")
    bundle, tok = build_llm_bundle(args)
    outs, captured = [], []
    for on in (True, False):
        sched = DecodeScheduler(bundle.module, bundle.cfg,
                                bundle.base_params, None, slots=2,
                                block_size=16, prefill_chunk=8, roofline=on)
        n0 = len(roofline.reports())
        slot, first = sched.admit([1] + tok.encode("roofline capture") + [3],
                                  max_new_tokens=4)
        toks = [first] + [sched.step()[slot] for _ in range(3)]
        sched.release(slot)
        outs.append(toks)
        captured.append({p: len(s) for p, s in
                         sched._roofline._captured.items()})
    assert outs[0] == outs[1]
    assert captured[0]["llm_decode_step"] == 1
    assert captured[0]["llm_prefill_chunk"] == 1
    assert captured[1] == {}
    for prog in ("llm_decode_step", "llm_prefill_chunk"):
        rep = roofline.report(prog)
        assert rep["total_flops"] > 0
        assert rep["attributed_share"] >= 0.9


# --- kernel rows, traceless capture, FlopCounterMode -------------------------

def test_kernel_row_reported_through_count_launch():
    """A hand-written kernel's launch inside a capture is one row with its
    shapes and ``core/kernels/cost.py``'s work, counted in ``analysed``
    and not in ``launches``."""
    from fedml_tpu_torch.core.kernels import count_launch
    from fedml_tpu_torch.core.kernels.cost import block_cost

    def stub():
        pass
    stub.launches = stub.captured = stub.analysed = 0
    nbytes, ops = block_cost(32, 32, 16, 16, 1, 2)

    def body():
        with roofline.repeat(5):
            count_launch(stub, lambda: (["bf16[32,32,32,16]"],
                                        "bf16[32,32,32,16]", nbytes, ops))
    rows = roofline.capture_rows(body)
    assert len(rows) == 1
    r = rows[0]
    assert (r.name, r.opcode, r.mult) == ("stub.0", "kernel", 5)
    assert (r.flops, r.bytes, r.known) == (ops, nbytes, True)
    assert (stub.launches, stub.analysed) == (0, 1)


def test_capture_leaves_the_program_as_it_was():
    sim = port_sim(dict(LR, model="cnn", dataset="synthetic_cifar10",
                        max_total_samples=64, client_num_per_round=2))
    sim.run_round(0, TrainHyper(learning_rate=0.1, epochs=1))
    (prog,) = sim.programs.values()
    before = {k: v.clone() for k, v in prog.params.items()}
    opt0 = {k: (v.clone() if torch.is_tensor(v) else
                {a: b.clone() for a, b in v.items()})
            for k, v in prog.opt_state.items()}
    steps = prog.steps
    rows = roofline.capture_rows(prog.analysis_step)
    assert rows
    for k, v in before.items():
        assert torch.equal(prog.params[k], v), k
    for k, v in opt0.items():
        got = prog.opt_state[k]
        if torch.is_tensor(v):
            assert torch.equal(got, v)
        else:
            assert all(torch.equal(got[a], b) for a, b in v.items())
    assert prog.steps == steps


def test_registry_flops_equal_flop_counter_mode():
    """The conv and matmul rows of a ResNet-20 step sum to
    ``FlopCounterMode``'s count of the same step (forward and backward),
    and the engine's ``round_cost_flops`` counts that step too."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry
    sim = port_sim(dict(LR, model="resnet20", dataset="synthetic_cifar10",
                        max_total_samples=32, client_num_per_round=1,
                        batch_size=4))
    hyper = TrainHyper(learning_rate=0.1, epochs=1)
    sim.run_round(0, hyper)
    (prog,) = sim.programs.values()
    names = {p.__name__ for p in flop_registry
             if hasattr(p, "__name__")}
    rows = roofline.capture_rows(prog.analysis_step)
    with FlopCounterMode(display=False) as fc:
        prog.analysis_step()
    got = sum(r.flops for r in rows if r.opcode in names)
    assert got == fc.get_total_flops() > 0
    steps = float(np.mean(np.sum(sim.batch_real, axis=-1)))
    assert sim.round_cost_flops(hyper) == pytest.approx(got * steps)


# --- the report CLI on the port's records ------------------------------------

def _port_log(tmp_path):
    from fedml_tpu_torch.core import mlops
    from fedml_tpu_torch.arguments import Arguments
    mlops.init(Arguments(log_file_dir=str(tmp_path), run_id="cli"))
    try:
        sim = port_sim(dict(LR, obs_roofline=True))
        hyper = TrainHyper(learning_rate=0.1, epochs=1)
        sim.run_round(0, hyper)
        _rebatch(sim, 8)
        sim.run_round(1, hyper)
    finally:
        mlops.init(Arguments(enable_tracking=False))
    (log,) = glob.glob(str(tmp_path / "**" / "*.jsonl"), recursive=True)
    return log


def _report_module():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import roofline_report
    return roofline_report


def test_report_renders_the_port_records(tmp_path, capsys):
    rr = _report_module()
    log = _port_log(tmp_path)
    assert rr.main([log, "--top", "4"]) == 0
    out = capsys.readouterr().out
    assert "== round — cpu x1" in out
    assert "STATIC-ONLY" in out
    assert "mm(f32[16,784],f32[784,10])" in out or "addmm(" in out
    assert "memory " in out
    assert "recompile forensics" in out
    assert "['train']['x']: float32[4,6,16,784] -> float32[4,12,8,784]" \
        in out


def test_report_min_attr_gate(tmp_path, capsys):
    rr = _report_module()
    log = _port_log(tmp_path)
    assert rr.main([log, "--min-attr", "0.9"]) == 0
    assert "coverage OK" in capsys.readouterr().out
    # an unattributed op (no rule names it) lowers the share below it
    rec = roofline.record_from_rows(
        "fft", roofline.capture_rows(lambda a: torch.fft.fft(a),
                                     (torch.ones(64),)))
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps(dict(rec, kind="roofline", ts=0.0,
                                run_id="t")) + "\n")
    assert rr.main([bad, "--min-attr", "0.9"]) == 2


def test_report_compare_mode(tmp_path, capsys):
    rr = _report_module()
    a = _port_log(tmp_path / "a")
    b = _port_log(tmp_path / "b")
    assert rr.main([a, "--compare", b]) == 0
    out = capsys.readouterr().out
    assert "predicted_mfu" in out and "collective_wire_bytes" in out
