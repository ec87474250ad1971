"""Every public constructor of vlfm_tpu_torch defaults to the card.

The port runs on the card unless the caller asks for the CPU: each
constructor's ``device`` defaults to ``vlfm_tpu_torch.device.default_device()``,
which is ``cuda``. Checked on the signatures, so nothing is allocated.
"""

import inspect

import pytest
import torch

from vlfm_tpu_torch.adapters.semexp import SemExpVLFMAgent
from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping import object_map, obstacle_map, value_map
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM
from vlfm_tpu_torch.models import detections
from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA
from vlfm_tpu_torch.models.grounding_dino import GroundingDinoDetector
from vlfm_tpu_torch.models.monodepth import MonocularDepth
from vlfm_tpu_torch.models.owl_vit import OwlViTDetector
from vlfm_tpu_torch.models.sam import SAM
from vlfm_tpu_torch.models.t5_vqa import T5VQA
from vlfm_tpu_torch.models.zoedepth import ZoeDepth
from vlfm_tpu_torch.ops import threefry
from vlfm_tpu_torch.policy import acyclic

CONSTRUCTORS = {
    "BLIP2ITM.init_random": BLIP2ITM.init_random,
    "BLIP2ITM.from_jax_params": BLIP2ITM.from_jax_params,
    "SAM.init_random": SAM.init_random,
    "SAM.from_jax_params": SAM.from_jax_params,
    "OwlViTDetector.init_random": OwlViTDetector.init_random,
    "OwlViTDetector.from_jax_params": OwlViTDetector.from_jax_params,
    "GroundingDinoDetector.init_random": GroundingDinoDetector.init_random,
    "GroundingDinoDetector.from_jax_params": GroundingDinoDetector.from_jax_params,
    "T5VQA.init_random": T5VQA.init_random,
    "T5VQA.from_jax_params": T5VQA.from_jax_params,
    "BLIP2VQA.init_random": BLIP2VQA.init_random,
    "BLIP2VQA.from_jax_params": BLIP2VQA.from_jax_params,
    "ZoeDepth.init_random": ZoeDepth.init_random,
    "ZoeDepth.from_jax_params": ZoeDepth.from_jax_params,
    "MonocularDepth.init_random": MonocularDepth.init_random,
    "value_map.create": value_map.create,
    "obstacle_map.create": obstacle_map.create,
    "obstacle_map.from_numpy": obstacle_map.from_numpy,
    "object_map.create": object_map.create,
    "threefry.PRNGKey": threefry.PRNGKey,
    "acyclic.create": acyclic.create,
    "GridSpec2D.zeros": GridSpec2D.zeros,
    "detections.empty": detections.empty,
    "detections.from_json": detections.from_json,
    "SemExpVLFMAgent": SemExpVLFMAgent.__init__,
}


def test_default_device_is_the_card():
    assert default_device() == torch.device("cuda")


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    default = inspect.signature(CONSTRUCTORS[name]).parameters["device"].default
    assert default == default_device(), f"{name} defaults to {default!r}"
