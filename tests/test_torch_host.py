"""vlfm_tpu_torch's host modules against their vlfm_tpu originals, and the
port's independence from jax and from vlfm_tpu.

The port carries its own ``config``, ``models.tokenizer``,
``models.coco_classes`` and ``runner.fake_env``, so that neither the package
nor ``chip_smoke.py`` loads anything of the JAX package. Held here: the same
config fields and defaults, the same token ids, the same COCO class table
and routing, and bit-identical environment frames along a spin and a walk.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vlfm_tpu import config as JCFG
from vlfm_tpu.models import coco_classes as JCOCO
from vlfm_tpu.models import tokenizer as JTOK
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu_torch import config as CFG
from vlfm_tpu_torch.models import coco_classes as COCO
from vlfm_tpu_torch.models import tokenizer as TOK
from vlfm_tpu_torch.runner import fake_env as ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["CameraConfig", "VLFMConfig"])
def test_config_fields_and_defaults_match_jax(name):
    port, ref = getattr(CFG, name), getattr(JCFG, name)
    assert _fields(port) == _fields(ref)
    got, want = dataclasses.asdict(port()), dataclasses.asdict(ref())
    assert got == want


def test_config_derived_values_match_jax():
    kw = dict(text_prompt="a target_object|another target_object", map_size=512)
    port, ref = CFG.VLFMConfig(**kw), JCFG.VLFMConfig(**kw)
    assert port.value_channels == ref.value_channels == 2
    for attr in ("hfov", "fx", "fy", "object_map_cone_fov"):
        assert getattr(port.camera, attr) == getattr(ref.camera, attr)


@pytest.mark.parametrize("max_len", [8, 32])
def test_tokenizer_ids_match_jax(max_len):
    extra = ["chair", "##s", "seems", "like"]
    texts = [
        "Seems like there is a chair ahead.",
        "  CHAIRS, beds; and a sofa!  ",
        "",
        "x" * 40,
        "zebra-crossing #1",
    ]
    got_ids, got_mask = TOK.WordPieceTokenizer(TOK.toy_vocab(extra), max_len).encode_batch(texts)
    want_ids, want_mask = JTOK.WordPieceTokenizer(JTOK.toy_vocab(extra), max_len).encode_batch(texts)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert got_ids.dtype == torch.int32


def test_tokenizer_unknown_word_matches_jax():
    vocab = {"[CLS]": 0, "[SEP]": 1, "[PAD]": 2, "[UNK]": 3, "ab": 4, "##c": 5}
    for text in ("abc", "abd", "ab ab c"):
        assert TOK.WordPieceTokenizer(vocab).encode(text) == JTOK.WordPieceTokenizer(vocab).encode(text)


def test_coco_classes_match_jax():
    assert COCO.COCO_CLASSES == JCOCO.COCO_CLASSES
    assert len(COCO.COCO_CLASSES) == 80


@pytest.mark.parametrize("target", ["toilet", "toilet|bed", "fireplace", "fireplace|couch", "tv|remote"])
def test_is_coco_target_matches_jax(target):
    assert COCO.is_coco_target(target) == JCOCO.is_coco_target(target)
    assert COCO.is_coco_target(target) is (target != "fireplace")


@pytest.mark.parametrize("seed", [0, 3])
def test_fake_env_frames_match_jax(seed):
    """A spin, a walk into the far wall (with collisions) and a stop."""
    cfg = dict(width=96, height=72, max_steps=40)
    port = ENV.FakeObjectNavEnv(ENV.two_room_plan(seed), ENV.EnvConfig(**cfg))
    ref = JENV.FakeObjectNavEnv(JENV.two_room_plan(seed), JENV.EnvConfig(**cfg))
    assert dataclasses.asdict(port.plan) == {
        k: v for k, v in dataclasses.asdict(ref.plan).items() if k != "stairs"
    }
    actions = [ENV.TURN_LEFT] * 11 + [ENV.TURN_RIGHT] * 2 + [ENV.MOVE_FORWARD] * 24 + [ENV.STOP]
    pairs = [(port.reset(), ref.reset())]
    pairs += [(port.step(a), ref.step(a)) for a in actions]
    assert port.collisions == ref.collisions > 0
    assert port.path_length == ref.path_length
    for got, want in pairs:
        assert set(got) == set(want) - {"agent_z"}
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert pairs[-1][0]["done"]


PORT_MODULES = [
    "vlfm_tpu_torch.models.coco_classes", "vlfm_tpu_torch.models.coco_detector",
    "vlfm_tpu_torch.models.owl_vit", "vlfm_tpu_torch.models.params", "vlfm_tpu_torch.models.sam",
    "vlfm_tpu_torch.models.tinyvit", "vlfm_tpu_torch.ops.conv_fused",
    "vlfm_tpu_torch.parallel.detection_pipeline",
]


def test_chip_smoke_and_profile_script_import_nothing_of_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import profile_torch_step, ab_spin_maps\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vlfm_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
