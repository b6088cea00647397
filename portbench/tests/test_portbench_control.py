"""The check that decides `correct` has to fail: the control (the
reference in float32 in the program's place) fails each cell's limits,
and a run of the harness with the timed path broken underneath comes out
not correct. On the CPU at a small size (the harness's look for a card
skipped); the readings at the cells' own size come from
portbench/control.py on the card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# the CPU's LAPACK can hang with more than one thread (the repo's tests
# keep one)
torch.set_num_threads(1)

from portbench import harness  # noqa: E402

SMALL = {"infer": {"n_side": 2, "frames_per_call": 4, "pool_batches": 2,
                   "warmup_calls": 1},
         "md": {"n_side": 2, "warmup_steps": 2, "check_every": 2}}
CELLS = ["water_se_e2_a.infer_b64", "water_se_e3.infer_b16",
         "water_se_e2_a.md_12k"]
SEED = 2**31 + 101


def _small(name):
    cell = harness.load_cell(name)
    return cell._replace(mix=dict(cell.mix, **SMALL[cell.mix["kind"]]))


def _run(cell, device="cpu"):
    return harness.run(cell, SEED, 0.5, False, device=device,
                       started=0.0, log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = _small(name)
    got = harness.traffic_module(cell).control(cell, SEED + 1, "cpu")
    assert any(v > cell.limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(_small(name))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


def _alter_answer(monkeypatch):
    from g4s_tpu_torch.models.deepmd.infer import DeepPot
    orig = DeepPot.eval

    def eval_(self, *a, **k):
        e, f, w = orig(self, *a, **k)
        f = f.clone()
        f[0, 1, 2] += 1e-7 * float(f.abs().max())
        return e, f, w
    monkeypatch.setattr(DeepPot, "eval", eval_)


def _half_batch(monkeypatch):
    from g4s_tpu_torch.models.deepmd.infer import DeepPot
    orig = DeepPot.eval

    def eval_(self, coords, box, types, *a, **k):
        h = len(coords) // 2
        out = orig(self, coords[:h], box[:h], types, *a, **k)
        return tuple(torch.cat([t, t]) for t in out)
    monkeypatch.setattr(DeepPot, "eval", eval_)


def _unchanged_step(monkeypatch):
    from g4s_tpu_torch.models.deepmd.md import NVTIntegrator
    monkeypatch.setattr(NVTIntegrator, "step",
                        lambda self, state, f: (state, f))


def _altered_force(monkeypatch):
    from g4s_tpu_torch.models.deepmd.md import NVTIntegrator
    orig = NVTIntegrator.step

    def step(self, state, f):
        state, f = orig(self, state, f)
        f = f.clone()
        f[3, 1] += 1e-7 * float(f.abs().max())
        return state, f
    monkeypatch.setattr(NVTIntegrator, "step", step)


@pytest.mark.parametrize("name,fault", [
    ("water_se_e2_a.infer_b64", _alter_answer),
    ("water_se_e2_a.infer_b64", _half_batch),
    ("water_se_e3.infer_b16", _alter_answer),
    ("water_se_e3.infer_b16", _half_batch),
    ("water_se_e2_a.md_12k", _unchanged_step),
    ("water_se_e2_a.md_12k", _altered_force),
], ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(_small(name))
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(_small(name), device="cuda")
    assert res["correct"] and res["device"]["platform"] == "gpu"
