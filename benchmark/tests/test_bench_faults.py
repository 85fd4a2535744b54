"""The judge on whole runs of cut cells on the CPU: a sound run is
correct, and each fault planted in the timed path makes it not correct."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.tests.small import measure_small

CELLS = ("headline-batch1000", "skew-batch1000")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = measure_small(cell)
    assert out["correct"], out["checks"]
    assert out["detail"]["rows"] > 1000
    assert out["detail"]["closed_rows"] > out["detail"]["overflow_rows"] > 0
    # the host's clocks read on the CPU too; the device's trace only on the card
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["metrics"].get("decisions_per_s", {"value": 1})["value"] > 0
    assert list(out)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from gubernator_tpu_torch.ops import kernel2

    monkeypatch.setattr(kernel2, "_write_claim", lambda *a, **k: None)


def _answer_altered(monkeypatch):
    from gubernator_tpu_torch.service import wire

    orig = wire.encode_response_columns

    def altered(status, limit, remaining, reset_time, *rest, **kw):
        remaining = np.array(remaining, copy=True)
        remaining[: remaining.size // 7 + 1] += 1
        return orig(status, limit, remaining, reset_time, *rest, **kw)

    monkeypatch.setattr(wire, "encode_response_columns", altered)


def _half_batch(monkeypatch):
    from gubernator_tpu_torch.ops import engine

    orig = engine.finish_check_columns

    def half(eng, pending, fixup):
        rc, delta = orig(eng, pending, fixup)
        h = rc.status.shape[0] // 2
        cols = [np.array(c, copy=True) for c in rc]
        for c in cols:
            c[h:2 * h] = c[:h]
        return type(rc)(*cols), delta

    monkeypatch.setattr(engine, "finish_check_columns", half)


def _fold_every_repeat(monkeypatch):
    """The planner folds every repeat of a key in a flush into one shared
    answer (max_exact 1), where the configuration answers its first 7
    rows there one at a time."""
    from gubernator_tpu_torch.ops import engine, plan

    monkeypatch.setattr(engine, "plan_passes", lambda hb, max_exact=8: plan.plan_passes(hb, 1))


FAULTS = {"state_unchanged": _state_unchanged, "answer_altered": _answer_altered,
          "half_batch_answered_from_the_rest": _half_batch,
          "every_repeat_folded": _fold_every_repeat}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = measure_small(cell)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_stale_replica_fails(cell):
    from benchmark.control import control_reading
    from benchmark.tests.small import small_cell

    _, _, cfg, traffic = small_cell(cell)
    r = control_reading(cell, seed=31337, requests=400, cfg=cfg, traffic=traffic)
    # sound runs read 0 wrong answers; the control has to read far more
    assert r["wrong_answers"] > r["rows"] // 100
