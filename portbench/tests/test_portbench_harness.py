"""CPU tests of the benchmark's harness: its files, the water generator,
the FLOP count, the trace reduction, the import rules and the command's
refusal without a card."""

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
sys.path.insert(0, str(ROOT))

from portbench import flops, frames, harness, tracing  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_workload_loads(cell):
    c = harness.load_cell(cell)
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
    assert (PB / "traffic" / f"{c.mix['kind']}.py").is_file()
    mod = harness.traffic_module(c)
    assert hasattr(mod, "Runner") and hasattr(mod, "control")
    assert c.config["name"] == w["config"]
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert hasattr(harness.load_module(PB / "metrics"
                                           / f"{m['name']}.py"), "read")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert data["precision"] == "float64" and data["tf32"] is False


def test_frames_deterministic_per_seed():
    a = frames.water_frames(frames.rng(2**31 + 7, "frames"), 2, 4)
    b = frames.water_frames(frames.rng(2**31 + 7, "frames"), 2, 4)
    c = frames.water_frames(frames.rng(2**31 + 8, "frames"), 2, 4)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


@pytest.mark.parametrize("n_side", [2, 3, 4])
def test_frames_geometry(n_side):
    x = frames.water_frame(frames.rng(11, "frames"), n_side)
    n = n_side ** 3
    L = frames.box_length(n_side)
    assert x.shape == (3 * n, 3) and (x >= 0).all() and (x < L).all()
    assert math.isclose(n * 18.015 / 6.02214076e23 / (L * 1e-8) ** 3, 0.995,
                        rel_tol=0.01)                     # g/cm^3
    o, h = x[:n], x[n:].reshape(n, 2, 3)

    def wrap(d):
        return d - L * np.round(d / L)
    oh = np.linalg.norm(wrap(h - o[:, None]), axis=-1)
    assert np.allclose(oh, frames.O_H_A, atol=1e-12)
    a, b = wrap(h[:, 0] - o), wrap(h[:, 1] - o)
    ang = np.degrees(np.arccos((a * b).sum(-1)
                               / np.linalg.norm(a, axis=-1)
                               / np.linalg.norm(b, axis=-1)))
    assert np.allclose(ang, frames.HOH_DEG, atol=1e-9)
    d = np.linalg.norm(wrap(x[None] - x[:, None]), axis=-1)
    mol = np.concatenate([np.arange(n), np.repeat(np.arange(n), 2)])
    other = mol[None] != mol[:, None]
    assert d[other].min() >= frames.O_H_A


def test_velocities_at_temperature_without_momentum():
    from portbench.reference import nvt
    m = np.where(frames.types(27) == 0, 16.0, 2.0)
    v = frames.velocities(frames.rng(3, "velocities"), m, 330.0,
                          nvt.KB_EV, nvt.F_OVER_M)
    assert np.abs((m[:, None] * v).sum(0)).max() < 1e-12
    import torch
    T = float(nvt.temperature(torch.as_tensor(m), torch.as_tensor(v)))
    assert math.isclose(T, 330.0, rel_tol=1e-12)


def _cfg(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


def test_flops_se_e2_a_by_hand():
    # 192 atoms, nnei 138, nets 1-25-50-100, axis 16, fit 1600-240-240-240-1
    embed = 192 * 138 * 2 * (25 + 25 * 50 + 50 * 100)
    contract = 192 * (138 * 4 * 100 + 4 * 100 * 16) * 2
    fit = 192 * 2 * (1600 * 240 + 2 * 240 * 240 + 240)
    own = 2 * (embed + fit) + 3 * contract
    f = flops.model_flops(_cfg("water_se_e2_a"), 192)
    assert f["own_type_only"] == own == 1_119_582_720
    assert f["total"] == 2 * own
    assert f["forward"] == 2 * (embed + contract + fit)


def test_flops_se_e3_by_hand():
    # pairs (t1 <= t2) 40*40 + 40*80 + 80*80; nets 1-2-4-8; fit 8-240-...-1
    pairs = 1600 + 3200 + 6400
    embed = 192 * pairs * 2 * (2 + 8 + 32)
    contract = 192 * pairs * 2 * (3 + 8)
    fit = 192 * 2 * (8 * 240 + 2 * 240 * 240 + 240)
    f = flops.model_flops(_cfg("water_se_e3"), 192)
    assert f["own_type_only"] == 2 * embed + 3 * contract + 2 * fit
    assert f["total"] == 2 * embed + 3 * contract + 2 * 2 * fit
    assert f["forward"] == embed + contract + 2 * fit


def test_trace_reduction_on_plain_events():
    device = [(100, 200, "k1", 1), (150, 260, "k2", 2), (400, 450, "k1", 1),
              (10, 50, "early", 3), (900, 1100, "late", 2)]
    host_ops = [(1, "aten::mm", [[8, 4], [4, 2]]),
                (2, "aten::topk", [[8, 8], [], [], [], []]),
                (3, "aten::add", [[1]])]
    host = {7: [(60, 300, "aten::mm"), (300, 700, "aten::topk"),
                (310, 320, "cudaLaunchKernel")],
            9: [(460, 480, "autograd::engine::evaluate_function: X")]}
    spans = [(60, 310, "portbench.eval"), (310, 990, "portbench.read")]
    tr = tracing.build((60, 1000), device, host_ops, host, spans)
    assert tracing.merged(tr) == [(100, 260), (400, 450), (900, 1000)]
    assert tracing.busy_s(tr) == 310e-9
    assert tracing.gaps(tr) == [(60, 100), (260, 400), (450, 900)]
    assert tracing.self_device_s(tr, "aten::mm") == 150e-9
    assert tracing.self_device_s(tr, "aten::topk") == 210e-9
    assert tracing.gap_label(tr, 80) == "portbench.eval > aten::mm"
    assert tracing.gap_label(tr, 470) == \
        "portbench.read > autograd::engine::evaluate_function: X"
    assert tracing.gap_label(tr, 800) == "portbench.read > python"
    assert tracing.idle_by_host(tr) == [
        ["portbench.read > aten::topk", 5.9e-7],
        ["portbench.eval > aten::mm", 4e-8]]
    assert tracing.device_ops(tr) == [["k1", 1.5e-7], ["k2", 1.1e-7],
                                      ["late", 1e-7]]
    (mm,) = [op for op in tr.ops if op.name == "aten::mm"]
    assert tracing.gemm_work(mm) == (2 * 8 * 2 * 4, 32 + 8 + 16)
    r = tracing.gemm_roofline(tr, 1e9, 1e9, 8)
    assert r["ops"] == 1 and r["bound"] == "memory"
    assert math.isclose(r["share_pct"], 100 * 56 * 8 / 1e9 / 150e-9)


class _Event:
    """A stand-in for one of torch.profiler's raw (kineto) events."""

    def __init__(self, name, kind, start, end, corr=0, linked=0,
                 shapes=()):
        self._name, self._kind = name, kind
        self._start, self._end = start, end
        self._corr, self._linked, self._shapes = corr, linked, list(shapes)

    def name(self):
        return self._name

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._kind == "kernel" else DeviceType.CPU

    def is_user_annotation(self):
        return self._kind == "user_annotation"

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return 1

    def shapes(self):
        return self._shapes


def test_from_profile_ignores_overhead_ids():
    # a launch that waits for room in the queue leaves an overhead event
    # whose id equals the launching op's: the kernel stays the op's
    events = [
        _Event(tracing.WINDOW, "user_annotation", 0, 1000, corr=1),
        _Event("aten::topk", "cpu_op", 10, 500, corr=7,
               shapes=[[4, 8], [], [], [], []]),
        _Event("Command Buffer Full", "overhead", 20, 400, corr=7),
        _Event("cudaLaunchKernel", "cuda_runtime", 400, 450, corr=99,
               linked=7),
        _Event("gatherTopK", "kernel", 460, 700, corr=99, linked=7),
    ]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events
    tr = tracing.from_profile(Prof)
    assert tracing.self_device_s(tr, "aten::topk") == 240e-9
    assert tracing.busy_s(tr) == 240e-9


def test_gemm_work_shapes():
    Op = tracing.Op
    assert tracing.gemm_work(Op("aten::addmm", [[5], [3, 4], [4, 5]], 1)) \
        == (2 * 3 * 5 * 4, 12 + 20 + 15 + 5)
    assert tracing.gemm_work(Op("aten::bmm", [[2, 3, 4], [2, 4, 5]], 1)) \
        == (2 * 2 * 3 * 5 * 4, 2 * (12 + 20 + 15))
    assert tracing.gemm_work(Op("aten::baddbmm",
                                [[2, 3, 5], [2, 3, 4], [2, 4, 5]], 1)) \
        == (2 * 2 * 3 * 5 * 4, 2 * (12 + 20 + 15) + 30)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top in ("__future__", "typing", "torch"), (path, mod)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "g4s_tpu_torch_like", sys)
    assert "g4s_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "g4s_tpu.sub", sys)
    assert "g4s_tpu" in harness.forbidden_modules()


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                          CELLS[0], "--seed", str(2**31 + 5), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_emit_ends_with_the_checks(capsys):
    checks = {"e_rel": {"value": 1e-15, "limit": 1e-9},
              "f_rel": {"value": 2e-15, "limit": 1e-9}}
    harness.emit({"correct": True, "attempted": 3, "failed": 0,
                  "metrics": {}, "device": {}, "checks": checks})
    out, err = capsys.readouterr()
    last = json.loads(out.splitlines()[-1])
    assert list(last)[-1] == "checks" and last["checks"] == checks
    assert err.splitlines()[-2:] == ["check e_rel = 1e-15 (limit 1e-09)",
                                     "check f_rel = 2e-15 (limit 1e-09)"]
