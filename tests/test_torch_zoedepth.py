"""vlfm_tpu_torch's ZoeDepth against vlfm_tpu's, on the CPU.

``tiny_test`` with one domain (NYU) and with two (NK, its router's patch
transformer included) gets seeded numpy weights in JAX's tree
(``jax.eval_shape`` of the init), carried into the port with
``from_jax_params``. Both run f32 (JAX's matmuls at "highest", as
tests/test_zoedepth.py runs them). Held against JAX: the resize's two
corner conventions to 1e-6, metric depth to 1e-5 m (the depths are ~1 m),
the router's logits to 1e-5, ``infer_depth`` to 1e-6 in [0, 1], and, under
``cast_for_serving``, an f32 stream in both and a depth within 1e-3 m of
JAX's served one.

NK routes each lane by its own domain logits, so B = 3 equals three B = 1
runs, each equal to JAX's B = 1 run. JAX (and upstream) route a batch by one
vote over its summed logits: with the router's bias set so the lanes'
choices split, JAX's B = 3 depth differs from its B = 1 depths on a lane
(ROADMAP Queue 3).
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_full_stack import numpy_params
from vlfm_tpu.models import zoedepth as JZ
from vlfm_tpu.models.precision import cast_for_serving as jax_cast_for_serving
from vlfm_tpu_torch.models import monodepth as MD
from vlfm_tpu_torch.models import zoedepth as Z
from vlfm_tpu_torch.models.precision import cast_for_serving

DEPTH_ATOL = 1e-5  # metres
RESIZE_ATOL = 1e-6
INFER_ATOL = 1e-6
SERVED_ATOL = 1e-3  # metres, bf16 weights
BINS = (("nyu", 8, 1e-3, 10.0), ("kitti", 8, 1e-3, 80.0))


def configs(two_domains: bool):
    jcfg, tcfg = JZ.ZoeDepthJaxConfig.tiny_test(), Z.ZoeDepthConfig.tiny_test()
    if two_domains:
        jcfg = dataclasses.replace(jcfg, bin_configurations=BINS)
        tcfg = dataclasses.replace(tcfg, bin_configurations=BINS)
    return jcfg, tcfg


@lru_cache(maxsize=None)
def jax_module(two_domains: bool):
    """One flax module per configuration, so JAX's jitted run is compiled
    once per input shape for the whole file."""
    return JZ.ZoeDepthModule(configs(two_domains)[0])


def jax_model(two_domains: bool, params) -> "JZ.ZoeDepth":
    jz = JZ.ZoeDepth(configs(two_domains)[0], jax.tree_util.tree_map(jnp.asarray, params))
    jz.module = jax_module(two_domains)
    return jz


@lru_cache(maxsize=None)
def tree(two_domains: bool, seed: int):
    return numpy_params(jax_module(two_domains), jnp.zeros((1, 64, 64, 3)), seed=seed)


def models(two_domains: bool, seed=0):
    p = jax.tree_util.tree_map(np.copy, tree(two_domains, seed))
    return p, jax_model(two_domains, p), Z.ZoeDepth.from_jax_params(configs(two_domains)[1], p, device="cpu")


def jax_run(jz, pixels, params=None):
    with jax.default_matmul_precision("highest"):
        depth, logits = jz._run(jz.module, jz.params if params is None else params, jnp.asarray(pixels))
    return np.asarray(depth), None if logits is None else np.asarray(logits)


def _pixels(b=3, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 64, 64, 3)).astype(np.float32)


def test_configs_match_jax():
    for t, j in ((Z.ZoeDepthConfig(), JZ.ZoeDepthJaxConfig()), (Z.ZoeDepthConfig.nk(), JZ.ZoeDepthJaxConfig.nk()),
                 (Z.ZoeDepthConfig.tiny_test(), JZ.ZoeDepthJaxConfig.tiny_test())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_corners_matches_jax(align_corners):
    x = np.random.default_rng(1).normal(size=(2, 6, 5, 3)).astype(np.float32)
    for size in ((12, 10), (3, 4), (1, 7)):
        want = np.asarray(JZ._resize_bilinear(jnp.asarray(x), size, align_corners))
        got = Z.resize_corners(torch.from_numpy(x), size, align_corners).numpy()
        np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("two_domains", [False, True], ids=["nyu", "nk"])
def test_metric_depth_matches_jax(two_domains):
    _, jz, tz = models(two_domains)
    px = _pixels()
    with torch.no_grad():
        got, logits = tz.module(torch.from_numpy(px))
    singles = [jax_run(jz, px[i:i + 1]) for i in range(3)]
    assert got.shape == (3, 64, 64) and bool(torch.isfinite(got).all())
    for i, (want, want_logits) in enumerate(singles):
        np.testing.assert_allclose(got[i:i + 1].numpy(), want, atol=DEPTH_ATOL, rtol=0)
        if two_domains:
            np.testing.assert_allclose(logits[i:i + 1].numpy(), want_logits, atol=DEPTH_ATOL, rtol=0)
    if not two_domains:
        assert logits is None
    # each lane alone gives its lane of the batch
    for i in range(3):
        np.testing.assert_allclose(tz.predict(torch.from_numpy(px[i:i + 1])).numpy(), got[i:i + 1].numpy(),
                                   atol=DEPTH_ATOL, rtol=0)


def test_nk_routes_each_lane_and_jax_votes_over_the_batch():
    p, jz, tz = models(True)
    px = _pixels()
    with torch.no_grad():
        _, logits = tz.module(torch.from_numpy(px))
    margin = (logits[:, 1] - logits[:, 0]).numpy()
    # shift the kitti logit so the lanes' choices split around the median
    bias = np.array(p["metric_head"]["mlp_classifier2"]["bias"])
    bias[1] -= float(np.median(margin))
    p["metric_head"]["mlp_classifier2"]["bias"] = bias
    jz = jax_model(True, p)
    tz = Z.ZoeDepth.from_jax_params(configs(True)[1], p, device="cpu")
    with torch.no_grad():
        got, logits = tz.module(torch.from_numpy(px))
    choice = logits.argmax(dim=-1)
    assert 0 < int(choice.sum()) < 3, "the lanes must split between the domains"
    singles = [jax_run(jz, px[i:i + 1])[0] for i in range(3)]
    for i in range(3):
        np.testing.assert_allclose(got[i:i + 1].numpy(), singles[i], atol=DEPTH_ATOL, rtol=0)
    batched = jax_run(jz, px)[0]
    off = [float(np.abs(batched[i] - singles[i][0]).max()) for i in range(3)]
    assert max(off) > 1e-2, f"JAX's batch vote should move a lane off its B = 1 depth: {off}"


@pytest.mark.parametrize("two_domains", [False, True], ids=["nyu", "nk"])
def test_infer_depth_matches_jax(two_domains):
    _, jz, tz = models(two_domains, seed=1)
    rgb = np.random.default_rng(2).integers(0, 256, (1, 48, 64, 3), dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jz.infer_depth(jnp.asarray(rgb), 0.5, 5.0))
    got = tz.infer_depth(torch.from_numpy(rgb), 0.5, 5.0)
    assert got.shape == (1, 48, 64) and float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=INFER_ATOL, rtol=0)


def test_served_depth_is_f32_and_matches_jax():
    p, jz, _ = models(True, seed=3)
    jp = jax_cast_for_serving(jax.tree_util.tree_map(jnp.asarray, p))
    assert jp["backbone"]["layer0"]["q"]["kernel"].dtype == jnp.bfloat16
    assert jp["backbone"]["layer0"]["ln_before"]["scale"].dtype == jnp.float32
    tz = Z.ZoeDepth.from_jax_params(configs(True)[1], jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    cast_for_serving(tz.module)
    assert tz.module.backbone.layer0.q.weight.dtype == torch.bfloat16
    assert tz.module.backbone.layer0.ln_before.weight.dtype == torch.float32
    px = _pixels(1, seed=4)
    served = jax.eval_shape(lambda q, x: jz.module.apply({"params": q}, x), jp, jnp.asarray(px))
    assert served[0].dtype == jnp.float32 and served[1].dtype == jnp.float32
    # Served, JAX computes in f32 on the bf16 weights, which is its f32
    # program on the weights rounded to bf16 (one compile fewer).
    want = jax_run(jz, px, jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp))[0]
    got = tz.predict(torch.from_numpy(px))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=SERVED_ATOL, rtol=0)


def test_monocular_depth_factory_is_a_tiny_zoedepth():
    m = MD.MonocularDepth.init_random(seed=0, device="cpu")
    assert isinstance(m, Z.ZoeDepth) and m.cfg == Z.ZoeDepthConfig.tiny_test()
    again = MD.MonocularDepth.init_random(seed=0, device="cpu")
    rgb = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 24, 32, 3), dtype=np.uint8))
    d = m.infer_depth(rgb, 0.5, 5.0)
    assert d.shape == (2, 24, 32) and torch.equal(d, again.infer_depth(rgb, 0.5, 5.0))
    assert float(d.min()) >= 0.0 and float(d.max()) <= 1.0
