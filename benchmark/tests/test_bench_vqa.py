"""The veto cell's driver and check (``drivers/dispatch_vqa.py``) through a
whole run on the CPU at the tiny preset: a sound run is correct and
compares the nine numbers; the control and faults planted in the port's
veto are not correct, and so is a fault planted in the port's ViT and in
the frozen copy alike, which only the reference written apart sees."""

import json

import pytest
import torch

from benchmark.control import control_numbers
from benchmark.run import run_cell
from benchmark.tests.tiny import DATA, TINY_LIMITS, tiny_cell

SEED = 2**31 + 91
# The tiny cell's limits for the veto, set from its CPU readings as TINY_LIMITS are:
# the port's T5 reads 0 against the reference's (the same float32 products on the CPU),
# the control's (T5's products in TF32) 6.3e-4 to 9.2e-4 over three seeds.
VQA_LIMITS = {"vqa_prefix_rms": 0.01, "vqa_logit_rms": 1e-4, "answer_off": 0.0}


def cell():
    c = tiny_cell("hm3d-b8-vqa", lanes=2)
    c.config = json.loads((DATA / "tiny-hm3d-vqa.json").read_text())
    c.mix = {**c.mix, "vqa": {"slot_capacity": 3, "answer_tokens": 4},
             "check": {**c.mix["check"], "tie_margin": 0.001, "limits": {**TINY_LIMITS, **VQA_LIMITS}}}
    return c


def run():
    return run_cell(cell(), seed=SEED, seconds=0.5, trace=False, device="cpu")


def test_a_sound_run_is_correct(capfd):
    result = run()
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(TINY_LIMITS) | set(VQA_LIMITS)
    assert result["failed"] == 0 and result["attempted"] >= 3
    err = capfd.readouterr().err
    asked = int(err.split("[check] veto: ")[1].split(" slots asked")[0])
    assert asked > 0, err


def test_the_control_fails_the_logits():
    n = control_numbers(cell(), SEED, 0.5, device="cpu")
    limits = {**TINY_LIMITS, **VQA_LIMITS}
    assert all(v <= limits[k] for k, v in n["program"].items()), n
    assert n["control"]["vqa_logit_rms"] > VQA_LIMITS["vqa_logit_rms"], n


def _heads_before_qkv(qkv, num_heads):
    """q, k and v read as (B, L, H, 3, D): EVA's (B, L, 3, H, D) misread."""
    b, l, three_hd = qkv.shape
    t = qkv.view(b, l, num_heads, 3, three_hd // (3 * num_heads)).permute(3, 0, 2, 1, 4)
    return t[0], t[1], t[2]


@pytest.mark.parametrize("fault", ["logit_scale", "no_reused_decoder_bias", "yes_flipped", "qkv_layout_in_both"])
def test_a_fault_in_the_ports_veto_is_not_correct(fault, monkeypatch):
    from vlfm_tpu_torch.models import t5_vqa as T

    if fault == "logit_scale":
        # A 1/sqrt(d_kv) logit scale, planted as the same factor on every query kernel of the port's T5.
        from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA

        init = BLIP2VQA.__init__

        def scaled(self, cfg, module, t5):
            init(self, cfg, module, t5)
            with torch.no_grad():
                for name, p in t5.module.named_parameters():
                    if name.endswith("attn.q.weight"):
                        p.mul_(cfg.t5.d_kv ** -0.5)

        monkeypatch.setattr(BLIP2VQA, "__init__", scaled)
    elif fault == "no_reused_decoder_bias":
        real = T.T5Block.forward

        def broken(self, x, enc=None, self_mask=None, enc_mask=None, position_bias=None):
            if self.is_decoder and not self.self_attn.has_rel_bias:
                position_bias = None
            return real(self, x, enc, self_mask, enc_mask, position_bias)

        monkeypatch.setattr(T.T5Block, "forward", broken)
    elif fault == "yes_flipped":
        monkeypatch.setattr(T.T5VQA, "answer_starts_with_yes", staticmethod(lambda gen, yes: gen[:, 0] != yes))
    else:
        # One fault in the port's ViT and in the frozen copy it descends from: ITM's check, which holds the
        # port to that copy, cannot see it; the veto's prefix, held to a ViT written apart, does.
        from benchmark.frozen.models import layers as frozen_layers
        from vlfm_tpu_torch.models import layers

        monkeypatch.setattr(layers, "qkv_views", _heads_before_qkv)
        monkeypatch.setattr(frozen_layers, "qkv_views", _heads_before_qkv)
    result = run()
    assert not result["correct"], result["compared"]
    bad = {k for k, v in result["compared"].items() if v["value"] > v["limit"]}
    want = {"yes_flipped": {"select_off"}, "qkv_layout_in_both": {"vqa_prefix_rms"}}.get(fault, {"vqa_logit_rms", "answer_off"})
    assert bad & want, result["compared"]
    if fault == "qkv_layout_in_both":
        assert result["compared"]["itm_cos_rms"]["value"] <= result["compared"]["itm_cos_rms"]["limit"]
