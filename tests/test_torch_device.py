"""Every public constructor of vlfm_tpu_torch defaults to the card.

The port runs on the card unless the caller asks for the CPU: each
constructor's ``device`` defaults to ``vlfm_tpu_torch.device.default_device()``,
which is ``cuda``. Checked on the signatures, so nothing is allocated.
"""

import inspect

import pytest
import torch

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping import obstacle_map, value_map
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM
from vlfm_tpu_torch.models.owl_vit import OwlViTDetector
from vlfm_tpu_torch.models.sam import SAM
from vlfm_tpu_torch.policy import acyclic

CONSTRUCTORS = {
    "BLIP2ITM.init_random": BLIP2ITM.init_random,
    "BLIP2ITM.from_jax_params": BLIP2ITM.from_jax_params,
    "SAM.init_random": SAM.init_random,
    "SAM.from_jax_params": SAM.from_jax_params,
    "OwlViTDetector.init_random": OwlViTDetector.init_random,
    "OwlViTDetector.from_jax_params": OwlViTDetector.from_jax_params,
    "value_map.create": value_map.create,
    "obstacle_map.create": obstacle_map.create,
    "obstacle_map.from_numpy": obstacle_map.from_numpy,
    "acyclic.create": acyclic.create,
    "GridSpec2D.zeros": GridSpec2D.zeros,
}


def test_default_device_is_the_card():
    assert default_device() == torch.device("cuda")


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    default = inspect.signature(CONSTRUCTORS[name]).parameters["device"].default
    assert default == default_device(), f"{name} defaults to {default!r}"
