"""The port's BLIP-2 flan-T5 and its detection veto against the benchmark's
plain reference (``benchmark/plain_blip2_t5.py``, written apart from the
port), on the CPU at the tiny preset.

Both sides take the same seeded weights (the port's ``init_random``, loaded
into the reference by name) and compute in float32. Held: the bucket grids
exactly; the visual prefix, the encoder's output and the decoder's logits
to ``ATOL`` (float32 on both sides, with other orders of summation: the
port's fused ViT blocks and promoted matmuls against the reference's plain
ones move the last bits); the logits at every position under teacher
forcing of the port's tokens; the greedy tokens wherever the reference's
top-1/top-2 margin is above ``TIE`` (a hundred times ``ATOL``: a smaller
margin may flip with the last bits); the contour ring and the questions
exactly; the veto's kept validity at several capacities (one batch, a
clamped last window, a phrase bank) and on the fused dispatch, slot for
slot wherever the first token is no tie. A fault planted in the port (a
1/sqrt(d) logit scale, or the decoder's later layers without the reused
position bias) moves the logits far past ``ATOL``.
"""

import copy
import dataclasses
import math
import zlib

import numpy as np
import pytest
import torch

from benchmark import plain_blip2_t5 as R
from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.models import t5_vqa as T
from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA, BLIP2VQAConfig
from vlfm_tpu_torch.models.precision import cast_for_serving
from vlfm_tpu_torch.ops.morphology import dilate, erode
from vlfm_tpu_torch.parallel.detection_pipeline import VQAVeto
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as ENV
from vlfm_tpu_torch.runner import packing as PK
from vlfm_tpu_torch.runner.full_stack import FullStackPerception

ATOL = 2e-5
TIE = 100 * ATOL
STEPS = 4
H, W = 40, 48


def dims(cfg: BLIP2VQAConfig) -> R.Dims:
    """The reference's widths, read off the port's configuration."""
    return R.Dims.from_json({"vit": dataclasses.asdict(cfg.vit), "qformer": dataclasses.asdict(cfg.qformer),
                             "t5": dataclasses.asdict(cfg.t5)})


@pytest.fixture(scope="module")
def pair():
    port = BLIP2VQA.init_random(BLIP2VQAConfig.tiny(), seed=5, device="cpu")
    ref = R.BLIP2T5(dims(port.cfg), device="cpu")
    ref.prefix.load_state_dict(port.module.state_dict())
    ref.t5.load_state_dict(port.t5.module.state_dict())
    return port, ref


def frames(n, seed=0, h=H, w=W):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=gen, dtype=torch.uint8)


def questions(n, seed=1, length=8, vocab=100):
    """Ids and masks, some rows padded at the end."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(2, vocab, (n, length), generator=gen)
    mask = torch.ones(n, length, dtype=torch.bool)
    for r in range(n):
        mask[r, length - (r % 3):] = False
    return ids * mask, mask


def margin(logits):
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def encode_text(text):
    """A stand-in tokenizer: one id a word (from its crc32), at most 8, 0
    padding."""
    ids = np.zeros(8, np.int64)
    raw = [3 + zlib.crc32(w.encode()) % 90 for w in text.split()][:8]
    ids[: len(raw)] = raw
    return ids, ids != 0


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_grids_equal_the_ports(bidirectional):
    want = T.bucket_table(300, 300, bidirectional, 32, 128, torch.device("cpu"))
    assert torch.equal(R.bucket_grid(300, 300, bidirectional, 32, 128), want)


def test_prefix_matches(pair):
    port, ref = pair
    rgb = frames(3)
    got = port.image_prefix(port.preprocess(rgb))
    want = ref.image_prefix(rgb)
    assert got.shape == want.shape == (3, port.cfg.qformer.num_queries, port.cfg.t5.d_model)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("with_prefix", [True, False])
def test_encoder_and_decoder_logits_match(pair, with_prefix):
    port, ref = pair
    ids, mask = questions(3)
    prefix = ref.image_prefix(frames(3)) if with_prefix else None
    with torch.no_grad():
        enc, m = port.t5.module.encode(ids, mask, prefix)
        want_enc, want_m = ref.t5.encode(ids, mask, prefix)
        torch.testing.assert_close(enc, want_enc, rtol=0, atol=ATOL)
        assert torch.equal(m, want_m)
        dec = torch.randint(2, 100, (3, STEPS + 1), generator=torch.Generator().manual_seed(5))
        torch.testing.assert_close(port.t5.module.decode_logits(dec, enc, m), ref.t5.decode(dec, want_enc, want_m),
                                   rtol=0, atol=ATOL)


def _port_answer(port, rgb, ids, mask):
    """The port's greedy tokens and its logits at every position of them."""
    prefix = port.image_prefix(port.preprocess(rgb))
    tokens = port.t5.generate(ids, mask, max_new_tokens=STEPS, prefix=prefix)
    with torch.no_grad():
        enc, m = port.t5.module.encode(ids, mask, prefix)
        start = torch.zeros_like(tokens[:, :1])
        logits = port.t5.module.decode_logits(torch.cat([start, tokens], dim=1), enc, m)[:, :STEPS]
    return prefix, tokens, logits


def test_logits_under_teacher_forcing_and_greedy_tokens_match(pair):
    port, ref = pair
    rgb, (ids, mask) = frames(6, seed=4), questions(6, seed=6)
    prefix, tokens, logits = _port_answer(port, rgb, ids, mask)
    forced = ref.forced(prefix, ids, mask, tokens)
    torch.testing.assert_close(logits, forced, rtol=0, atol=ATOL)
    own = ref.answer(rgb, ids, mask, STEPS)
    compared = 0
    for row in range(tokens.shape[0]):
        for i in range(STEPS):
            if float(margin(own["logits"][row, i])) <= TIE:
                break  # a near tie: the histories may part here
            assert int(own["tokens"][row, i]) == int(tokens[row, i]), (row, i)
            compared += 1
    assert compared >= STEPS * tokens.shape[0] // 2


def test_the_ring_and_the_questions_equal_the_ports():
    gen = torch.Generator().manual_seed(9)
    masks = torch.rand(3, 2, H, W, generator=gen) > 0.6
    masks[0, 0] = False
    masks[0, 0, :5, :7] = True  # touches the frame's corner
    masks[1, 1] = True  # the whole frame: only the erosion's border matters
    assert torch.equal(R.contour_ring(masks), dilate(masks, 3) & ~erode(masks, 3))
    rgb = frames(3, seed=2)
    assert torch.equal(R.annotate(rgb, masks), VQAVeto.annotate(rgb, masks))
    port = VQAVeto(vqa=None, encode_text=encode_text, yes_token_id=0)
    for phrase in ("toilet", "potted plant", "sitting"):
        assert R.question(phrase) == port.question_for(phrase)


def _boxes(b, k, seed):
    gen = torch.Generator().manual_seed(seed)
    masks = torch.zeros(b, k, H, W, dtype=torch.bool)
    for i in range(b):
        for j in range(k):
            y0, x0 = (int(v) for v in torch.randint(0, H // 2, (2,), generator=gen))
            masks[i, j, y0:y0 + H // 3, x0:x0 + W // 3] = True
    return masks


def _agree(port_kept, ref_kept, asked):
    """Slots whose first token is no tie agree; returns how many were held."""
    held = 0
    for a in asked:
        for r, s in enumerate(a["slots"]):
            if float(margin(a["logits"][r, 0])) > TIE:
                b, k = divmod(s, port_kept.shape[1])
                assert bool(port_kept[b, k]) == bool(ref_kept[b, k]), s
                held += 1
    return held


B, K = 2, 6
VALID = torch.tensor([[True, False, True, True, False, True], [False, True, True, False, True, False]])
CLS = torch.tensor([[0, 1, 2, 5, 0, 1], [2, 2, 1, 0, -1, 0]])
BANK = ["toilet", "bed", "sitting"]


def _veto_inputs():
    return frames(B, seed=1), _boxes(B, K, 1) & VALID[:, :, None, None]


@pytest.fixture(scope="module")
def yes_id(pair):
    """The port's commonest first answer over the test's slots and phrases,
    so that the veto keeps some slots and drops others."""
    port, _ = pair
    rgb, masks = _veto_inputs()
    images = port.image_prefix(port.preprocess(R.annotate(rgb, masks)))
    firsts = []
    for phrase in BANK:
        ids, mask = (torch.as_tensor(t)[None].expand(B * K, -1) for t in encode_text(R.question(phrase)))
        firsts += port.t5.generate(ids, mask, max_new_tokens=1, prefix=images)[:, 0].tolist()
    assert len(set(firsts)) > 1, firsts
    return max(set(firsts), key=firsts.count)


class Recorder:
    """The port veto's passes: each pass's images and question ids."""

    def __init__(self, veto):
        self.passes = []
        prefix, generate = veto.image_prefix, veto.vqa.generate
        veto.image_prefix = lambda x: self.passes.append({"frames": x.clone()}) or prefix(x)

        def recorded(ids, mask, max_new_tokens=8, prefix=None):
            tokens = generate(ids, mask, max_new_tokens=max_new_tokens, prefix=prefix)
            self.passes[-1].update(ids=ids.clone(), tokens=tokens)
            return tokens

        veto.vqa = copy.copy(veto.vqa)
        veto.vqa.generate = recorded


@pytest.mark.parametrize("capacity,phrases", [(None, "toilet"), (1, "toilet"), (3, "toilet"), (4, "toilet"),
                                              (5, BANK), (4, BANK), (12, BANK)],
                         ids=["one-batch", "cap1", "cap3", "cap4-clamped", "cap5-bank", "cap4-bank-clamped",
                              "cap12-bank"])
def test_the_veto_matches(pair, yes_id, capacity, phrases):
    """The same passes (the frames each asks about, exactly, and their
    questions), the same tokens away from near ties, and the same kept
    validity."""
    port, ref = pair
    rgb, masks = _veto_inputs()
    veto = VQAVeto(vqa=port.t5, encode_text=encode_text, yes_token_id=yes_id,
                   image_prefix=lambda x: port.image_prefix(port.preprocess(x)), slot_capacity=capacity)
    rec = Recorder(veto)
    got = veto(rgb, masks, VALID, phrases, CLS)
    want, asked = R.Veto(ref, encode_text, yes_id, capacity=capacity)(rgb, masks, VALID, phrases, CLS)
    n_valid = int(VALID.sum())
    assert len(asked) == len(rec.passes) == (1 if capacity in (None, 12) else math.ceil(n_valid / capacity))
    for p, a in zip(rec.passes, asked):
        assert torch.equal(p["frames"], a["frames"]) and torch.equal(p["ids"], a["ids"])
        sure = margin(a["logits"][:, 0]) > TIE
        assert torch.equal(p["tokens"][:, 0][sure], a["tokens"][:, 0][sure])
    assert _agree(got, want, asked) >= n_valid - 1
    assert not bool((got & ~VALID).any())
    if capacity in (3, 12):
        assert 0 < int(got.sum()) < n_valid  # some kept, some dropped


def test_the_fused_dispatch_matches_the_references_verdicts(pair, yes_id):
    """Two lanes of the packed fused dispatch with the veto gated at 3
    slots: every veto call's kept validity equals the reference's on the
    same inputs."""
    port, ref = pair
    lanes = 2
    cfg = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=H, width=W), max_frontiers=16,
                             max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128,
                             max_detections_per_frame=4, sam_frame_capacity=1, depth_image_shape=(H, W),
                             use_vqa=True, vqa_slot_capacity=3)
    spec = GridSpec2D(512, 20, 160)
    layout = PK.build_layout([("depth", "float32", (lanes, H, W)), ("rgb", "uint8", (lanes, H, W, 3)),
                              ("heading", "float32", (lanes,)), ("xy", "float32", (lanes, 2)),
                              ("seeds", "int32", (lanes,)), ("steps", "int32", (lanes,)),
                              ("reset", "uint8", (lanes,))])
    perception = FullStackPerception(cfg, blip2_vqa=port, yes_token_id=yes_id, device="cpu")
    veto = perception.pipeline.vqa_veto
    calls = []

    def recorded(rgb, masks, valid, phrases, cls=None):
        kept = VQAVeto.__call__(veto, rgb, masks, valid, phrases, cls)
        calls.append((rgb.clone(), masks.clone(), valid.clone(), phrases, None if cls is None else cls.clone(), kept))
        return kept

    perception.pipeline.vqa_veto = recorded
    pointnav = PN.PointNavPolicy.init_random(0, depth_shape=(H, W), device="cpu")
    step = perception.make_fused_step(pointnav, spec, cfg, "toilet", layout=layout)
    buf = torch.empty(layout.total, dtype=torch.uint8)
    views = PK.pack_views(buf.numpy(), layout)
    env = ENV.FakeObjectNavEnv(ENV.two_room_plan(seed=1), ENV.EnvConfig(width=W, height=H))
    state = ITM.create_state(spec, cfg, batch=lanes, device="cpu")
    obs = env.reset()
    for t in range(3):
        for j in range(lanes):
            views["depth"][j], views["rgb"][j] = obs["depth"], obs["rgb"]
            views["heading"][j], views["xy"][j] = obs["heading"], obs["robot_xy"]
        views["seeds"][:], views["steps"][:], views["reset"][:] = range(lanes), t, int(t == 0)
        _, state = step(state, None, buf)
        obs = env.step(2)
    assert len(calls) == 3
    plain = R.Veto(ref, veto.encode_text, yes_id, capacity=3)
    held = 0
    for rgb, masks, valid, phrases, cls, kept in calls:
        want, asked = plain(rgb, masks, valid, phrases, cls)
        held += _agree(kept, want, asked)
    assert held > 0


def _logit_error(port, ref):
    rgb, (ids, mask) = frames(4, seed=11), questions(4, seed=12)
    prefix, tokens, logits = _port_answer(port, rgb, ids, mask)
    return float((logits - ref.forced(prefix, ids, mask, tokens)).abs().max())


@pytest.mark.parametrize("fault", ["logit_scale", "no_reused_decoder_bias"])
def test_a_fault_planted_in_the_port_fails(pair, fault, monkeypatch):
    port, ref = pair
    assert _logit_error(port, ref) <= ATOL
    if fault == "logit_scale":
        # q/sqrt(d) . k is the scaled logit: the fault as a weight change, undone after.
        scaled = [p for n, p in port.t5.module.named_parameters() if n.endswith("attn.q.weight")]
        with torch.no_grad():
            for p in scaled:
                p.mul_(port.cfg.t5.d_kv ** -0.5)
        try:
            err = _logit_error(port, ref)
        finally:
            with torch.no_grad():
                for p in scaled:
                    p.mul_(port.cfg.t5.d_kv ** 0.5)
    else:
        real = T.T5Block.forward

        def broken(self, x, enc=None, self_mask=None, enc_mask=None, position_bias=None):
            if self.is_decoder and not self.self_attn.has_rel_bias:
                position_bias = None
            return real(self, x, enc, self_mask, enc_mask, position_bias)

        monkeypatch.setattr(T.T5Block, "forward", broken)
        err = _logit_error(port, ref)
    assert err > 1000 * ATOL, err


def _served_pair(pair):
    """The port's T5 cast for serving, and the reference's T5 on the same
    served weights: rounded to bf16, the embedding table held in bf16."""
    port, ref = pair
    served = copy.deepcopy(port.t5.module)
    cast_for_serving(served)
    plain = copy.deepcopy(ref.t5)
    own = dict(served.named_parameters())
    with torch.no_grad():
        for name, p in plain.named_parameters():
            p.copy_(own[name].float())
    plain.embed.weight.data = plain.embed.weight.data.to(torch.bfloat16)
    return served, plain


def _t5_logits(t5, decode, seed=21):
    ids, mask = questions(3, seed=seed)
    prefix = torch.randn(3, 8, 32, generator=torch.Generator().manual_seed(seed))
    dec = torch.randint(2, 100, (3, STEPS + 1), generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        enc, m = t5.encode(ids, mask, prefix)
        return getattr(t5, decode)(dec, enc, m)


def test_the_served_t5_matches_the_reference_on_its_served_weights(pair):
    """bf16 weights, float32 products: the reference on the served
    weights holds the port's served T5 to float32's own error; the
    reference's weights left in float32 would not (the bf16 rounding)."""
    served, plain = _served_pair(pair)
    got = _t5_logits(served, "decode_logits")
    torch.testing.assert_close(got, _t5_logits(plain, "decode"), rtol=0, atol=ATOL)
    unrounded = float((got - _t5_logits(pair[1].t5, "decode")).abs().max())
    assert unrounded > 10 * ATOL, unrounded


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3)) * 1e3
    r = R.round_tf32(x)
    assert torch.equal(R.round_tf32(r), r)
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(r.view(torch.int32) & 0x1FFF, torch.zeros_like(r.view(torch.int32)))
    b = R.round_bf16(x)
    assert torch.equal(R.round_tf32(b), b)  # bf16 values are exact in TF32


@pytest.mark.parametrize("side", ["tf32", "bf16"])
def test_a_lower_precision_moves_t5s_logits_by_its_rounding(pair, side):
    """The controls' T5 (products' operands in TF32, or in and out in bf16)
    reads far above float32's own error and within its precision."""
    _, plain = _served_pair(pair)
    want = _t5_logits(plain, "decode")
    rounding = (R.round_tf32, R.same) if side == "tf32" else (R.round_bf16, R.round_bf16)
    got = _t5_logits(R.lower_matmuls_(copy.deepcopy(plain), *rounding), "decode")
    rel = float((got - want).norm() / want.norm())
    low, high = (1e-5, 1e-2) if side == "tf32" else (1e-4, 1e-1)
    assert low < rel < high, rel


def test_the_reference_runs_with_tf32_off_and_imports_no_port():
    """Inside the reference every matmul sees TF32 off, whatever the caller
    set, and the caller's flags come back; building and running it loads
    no module of the port or of JAX."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from benchmark import plain_blip2_t5 as R\n"
        "d = R.Dims(R.ViTDims(image_size=28, patch_size=14, width=16, depth=1, heads=2, mlp_dim=32),\n"
        "           R.QFormerDims(hidden=16, layers=1, heads=2, intermediate=32, num_queries=2, vocab_size=50),\n"
        "           R.T5Dims(vocab_size=50, d_model=16, d_kv=4, d_ff=32, heads=4, enc_layers=1, dec_layers=1))\n"
        "m = R.BLIP2T5(d)\n"
        "seen = []\n"
        "m.t5.lm_head.register_forward_pre_hook(lambda mod, a: seen.append(torch.backends.cuda.matmul.allow_tf32))\n"
        "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True\n"
        "ids = torch.ones(2, 3, dtype=torch.int64)\n"
        "m.answer(torch.zeros(2, 20, 24, 3, dtype=torch.uint8), ids, ids > 0, 2)\n"
        "assert seen and not any(seen), seen\n"
        "assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('vlfm_tpu_torch', 'vlfm_tpu', 'jax', 'flax')\n"
        "       or n.startswith('benchmark.frozen')]\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300,
                   env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
