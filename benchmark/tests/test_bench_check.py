"""The check that decides ``correct``, driven through a whole run on the
CPU at a tiny size (the chip look skipped): a sound run passes; the
control (the reference one precision down) and each fault the dispatch
cells can have, planted in the timed path, fail."""

import pytest
import torch

from benchmark.control import control_numbers
from benchmark.run import run_cell
from benchmark.tests.tiny import TINY_LIMITS, tiny_cell

SEED = 2**31 + 77


def run(**mix):
    return run_cell(tiny_cell(**mix), seed=SEED, seconds=0.5, trace=False, device="cpu")


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 3


def test_the_control_is_not_correct():
    n = control_numbers(tiny_cell(), SEED, 0.5, device="cpu")
    assert all(v <= TINY_LIMITS[k] for k, v in n["program"].items()), n
    assert any(v > TINY_LIMITS[k] for k, v in n["control"].items()), n


def _state_unchanged(step):
    def broken(state, *a, **kw):
        before = type(state)(*(type(v)(*(t.clone() for t in v)) if isinstance(v, tuple) else v.clone()
                               for v in state))
        action, info, _ = step(state, *a, **kw)
        return action, info, before
    return broken


def _half_batch(perceive):
    def broken(rgb, target, out_hw=None):
        cos, masks, valid = perceive(rgb, target, out_hw)
        half = max(1, cos.shape[0] // 2)
        fill = cos[:half].mean(dim=0, keepdim=True)  # the rest take the mean of the lanes kept
        return torch.cat([cos[:half], fill.expand(cos.shape[0] - half, -1)]), masks, valid
    return broken


def _answer_altered(pack):
    def broken(action, info):
        out = pack(action, info).clone()
        out[0, 0] = (out[0, 0] + 1) % 4
        return out
    return broken


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    from vlfm_tpu_torch.policy import itm
    from vlfm_tpu_torch.runner import full_stack

    if fault == "state_unchanged":
        monkeypatch.setattr(itm, "step", _state_unchanged(itm.step))
    elif fault == "answer_altered":
        monkeypatch.setattr(full_stack, "pack_outputs", _answer_altered(full_stack.pack_outputs))
    else:
        real = full_stack.FullStackPerception._perceive
        monkeypatch.setattr(full_stack.FullStackPerception, "_perceive",
                            lambda self, *a: _half_batch(lambda *b: real(self, *b))(*a))
    result = run()
    assert not result["correct"], result["compared"]
