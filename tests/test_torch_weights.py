"""vlfm_tpu_torch's checkpoint converters, serving bundle and ``--weights-dir``
against vlfm_tpu's, on the CPU.

- Each converter takes the same state dict as its JAX twin: a tiny
  ``transformers`` model with the JAX tests' configs, or a seeded MobileSAM
  state dict. The trees must have the same keys, dtypes and bits.
- BLIP2-ITM, OWL-ViT and MobileSAM loaded from those state dicts hold the
  JAX models' outputs to the f32 tolerances of ``test_torch_blip2_itm.py``,
  ``test_torch_owl_vit.py`` and ``test_torch_sam.py`` (1e-4).
- Every published config converts whole at full width: the HF model is
  built on the ``meta`` device and its state dict fed as zero-stride
  arrays, so nothing of that size is allocated.
- A bundle of all seven entries loads back with equal configs and
  bit-equal state dicts, serves a dispatch bit for bit as the in-memory
  stack, and writes JAX's manifest; the CLIs convert and serve, and refuse
  the JAX package's orbax bundles.

Importing ``transformers`` takes ~20 s, so every test that needs it lives
in this file.
"""

import dataclasses
import json
import sys
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mock_habitat
from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu.models import blip2_itm as JB
from vlfm_tpu.models import blip2_vqa as JBV
from vlfm_tpu.models import grounding_dino as JG
from vlfm_tpu.models import owl_vit as JO
from vlfm_tpu.models import qformer as JQ
from vlfm_tpu.models import sam as JS
from vlfm_tpu.models import swin as JSW
from vlfm_tpu.models import t5_vqa as JT
from vlfm_tpu.models import tinyvit as JTV
from vlfm_tpu.models import vit as JV
from vlfm_tpu.models import zoedepth as JZ
from vlfm_tpu.runner import weights as JW
from vlfm_tpu_torch import convert_checkpoints as CONVERT
from vlfm_tpu_torch import run as RUN
from vlfm_tpu_torch.config import CameraConfig, VLFMConfig
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models import blip2_itm as B
from vlfm_tpu_torch.models import blip2_vqa as BV
from vlfm_tpu_torch.models import grounding_dino as G
from vlfm_tpu_torch.models import owl_vit as O
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.models import swin as SW
from vlfm_tpu_torch.models import t5_vqa as T
from vlfm_tpu_torch.models import tinyvit as TV
from vlfm_tpu_torch.models import zoedepth as Z
from vlfm_tpu_torch.models.params import load_jax_params_, port_layout
from vlfm_tpu_torch.models.precision import cast_for_serving
from vlfm_tpu_torch.models.tokenizer import toy_vocab
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import full_stack as FS
from vlfm_tpu_torch.runner import weights as W
from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, open_room_plan

jax.config.update("jax_default_device", jax.devices("cpu")[0])

F32_ATOL = 1e-4  # the f32 tolerance of test_torch_blip2_itm.py, test_torch_owl_vit.py and test_torch_sam.py
META_PEAK_BYTES = 64 << 20  # host memory a full-width conversion may allocate (its f32 ITM alone is 4.7 GB)
JAX_NAMES = {"GroundingDinoJaxConfig": "GroundingDinoConfig", "ZoeDepthJaxConfig": "ZoeDepthConfig",
             "BeitConfigJx": "BeitConfig"}


def port_cfg(jcfg):
    """The port's twin of a JAX model config, through the manifest's dict
    form with the class names mapped."""
    def rename(d):
        if isinstance(d, dict):
            return {k: JAX_NAMES.get(v, v) if k == "__class__" else rename(v) for k, v in d.items()}
        return [rename(v) for v in d] if isinstance(d, list) else d

    return W._cfg_from_dict(rename(JW._cfg_to_dict(jcfg)), W._config_registry())


def seeded(shapes, seed):
    """A state dict of seeded f32 values for a key -> shape table, running
    variances positive, as tests/test_tinyvit.py makes it."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        v = rng.normal(0, 0.05, shape).astype(np.float32)
        sd[k] = np.abs(v) + 0.5 if k.endswith("running_var") else v
    return sd


# ---------------------------------------------------------------------------
# the tiny HF models of the JAX tests, each built once
# ---------------------------------------------------------------------------
def hf_blip2_itm():  # tests/test_blip2.py
    from transformers import Blip2Config, Blip2ForImageTextRetrieval, Blip2QFormerConfig, Blip2VisionConfig

    vc = Blip2VisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                           image_size=56, patch_size=14)
    qc = Blip2QFormerConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                            vocab_size=100, cross_attention_frequency=2, encoder_hidden_size=64,
                            use_qformer_text_input=True)
    cfg = Blip2Config.from_vision_qformer_text_configs(vc, qc, None)
    cfg.num_query_tokens, cfg.image_text_hidden_size = 8, 16
    torch.manual_seed(0)
    return Blip2ForImageTextRetrieval(cfg).eval()


def jax_blip2_itm_cfg():
    return JB.BLIP2ITMConfig(
        vit=JV.ViTConfig(image_size=56, patch_size=14, width=64, depth=2, heads=4, mlp_dim=128),
        qformer=JQ.QFormerConfig(hidden=32, layers=2, heads=4, intermediate=64, cross_attention_freq=2,
                                 num_queries=8, vocab_size=100),
        embed_dim=16, compute_dtype=jnp.float32)


def hf_owl_vit():  # tests/test_owl_vit.py
    from transformers import OwlViTConfig, OwlViTForObjectDetection

    cfg = OwlViTConfig(
        text_config=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
                         vocab_size=100, max_position_embeddings=16),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                           image_size=64, patch_size=8),
        projection_dim=16)
    cfg.text_config.projection_dim = cfg.vision_config.projection_dim = 16
    torch.manual_seed(0)
    return OwlViTForObjectDetection(cfg).eval()


def hf_sam():  # tests/test_sam.py
    from transformers import SamConfig as HFSamConfig, SamMaskDecoderConfig, SamModel, SamPromptEncoderConfig
    from transformers import SamVisionConfig as HFSamVisionConfig

    vc = HFSamVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                           image_size=64, patch_size=8, global_attn_indexes=[1], window_size=2, output_channels=16,
                           num_pos_feats=8)
    pc = SamPromptEncoderConfig(hidden_size=16, image_size=64, patch_size=8, mask_input_channels=4)
    mc = SamMaskDecoderConfig(hidden_size=16, num_hidden_layers=2, num_attention_heads=2, mlp_dim=32,
                              iou_head_depth=2, iou_head_hidden_dim=16)
    torch.manual_seed(0)
    return SamModel(HFSamConfig(vision_config=vc.to_dict(), prompt_encoder_config=pc.to_dict(),
                                mask_decoder_config=mc.to_dict())).eval()


def jax_sam_cfg():
    return JS.SamConfig(
        vision=JS.SamVisionConfig(image_size=64, patch_size=8, width=32, depth=2, heads=2, mlp_dim=128,
                                  window_size=2, global_attn_indexes=(1,), out_channels=16),
        decoder=JS.SamDecoderConfig(hidden=16, layers=2, heads=2, mlp_dim=32, iou_head_depth=2, iou_head_hidden=16),
        pe_dim=8)


def hf_swin():  # tests/test_swin.py
    from transformers import SwinBackbone, SwinConfig

    torch.manual_seed(0)
    return SwinBackbone(SwinConfig(
        image_size=64, patch_size=4, embed_dim=16, depths=[2, 2], num_heads=[2, 4], window_size=4,
        out_features=["stage1", "stage2"], hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0)).eval()


def hf_grounding_dino():  # tests/test_grounding_dino.py
    from transformers import GroundingDinoConfig, GroundingDinoForObjectDetection

    cfg = GroundingDinoConfig(
        backbone_config=dict(model_type="swin", image_size=64, patch_size=4, embed_dim=16, depths=[2, 2],
                             num_heads=[2, 4], window_size=4, out_features=["stage1", "stage2"],
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, drop_path_rate=0.0),
        text_config=dict(model_type="bert", hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, vocab_size=2000, max_position_embeddings=64, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0),
        d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=10, num_feature_levels=2, max_text_len=16,
        encoder_n_points=2, decoder_n_points=2, dropout=0.0, activation_dropout=0.0, fusion_dropout=0.0,
        fusion_droppath=0.0, text_enhancer_dropout=0.0, disable_custom_kernels=True)
    torch.manual_seed(0)
    return GroundingDinoForObjectDetection(cfg).eval()


def hf_zoedepth(two_domains: bool):  # tests/test_zoedepth.py
    from transformers import BeitConfig, ZoeDepthConfig, ZoeDepthForDepthEstimation

    bb = BeitConfig(image_size=64, patch_size=16, num_hidden_layers=4, hidden_size=32, intermediate_size=64,
                    num_attention_heads=2, use_relative_position_bias=True, reshape_hidden_states=False,
                    out_features=["stage1", "stage2", "stage3", "stage4"], layer_scale_init_value=0.1,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, drop_path_rate=0.0)
    bins = [{"name": "nyu", "n_bins": 8, "min_depth": 1e-3, "max_depth": 10.0}]
    if two_domains:
        bins.append({"name": "kitti", "n_bins": 8, "min_depth": 1e-3, "max_depth": 80.0})
    cfg = ZoeDepthConfig(backbone_config=bb, neck_hidden_sizes=[16, 24, 32, 32], fusion_hidden_size=32,
                         num_relative_features=8, bottleneck_features=32, num_attractors=[4, 2, 2, 1],
                         bin_embedding_dim=16, bin_configurations=bins, num_patch_transformer_layers=4,
                         patch_transformer_hidden_size=128, patch_transformer_intermediate_size=32,
                         patch_transformer_num_attention_heads=2)
    torch.manual_seed(0)
    model = ZoeDepthForDepthEstimation(cfg).eval()
    sd = model.state_dict()  # the parameters HF leaves constant (bias tables, CLS token, layer scales) randomised
    g = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if v.dtype.is_floating_point and float(v.std()) < 1e-8:
            sd[k] = torch.randn(v.shape, generator=g) * 0.05
    model.load_state_dict(sd)
    return model


def jax_zoedepth_cfg(two_domains: bool):
    bins = (("nyu", 8, 1e-3, 10.0),) + ((("kitti", 8, 1e-3, 80.0),) if two_domains else ())
    return JZ.ZoeDepthJaxConfig(
        beit=JZ.BeitConfigJx(image_size=64, patch_size=16, hidden_size=32, layers=4, heads=2, intermediate=64,
                             out_indices=(1, 2, 3, 4)),
        neck_hidden_sizes=(16, 24, 32, 32), fusion_hidden_size=32, num_relative_features=8, bottleneck_features=32,
        num_attractors=(4, 2, 2, 1), bin_embedding_dim=16, bin_configurations=bins, patch_transformer_hidden=128,
        patch_transformer_intermediate=32, patch_transformer_heads=2)


def _t5_config():  # tests/test_t5_vqa.py
    from transformers import T5Config

    return T5Config(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_layers=2, num_decoder_layers=2,
                    feed_forward_proj="gated-gelu", tie_word_embeddings=False, relative_attention_num_buckets=32,
                    relative_attention_max_distance=128, decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)


def hf_t5():
    from transformers import T5ForConditionalGeneration

    torch.manual_seed(0)
    return T5ForConditionalGeneration(_t5_config()).eval()


def hf_blip2_t5():  # tests/test_blip2_vqa.py
    from transformers import Blip2Config, Blip2ForConditionalGeneration, Blip2QFormerConfig, Blip2VisionConfig

    vc = Blip2VisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                           image_size=56, patch_size=14)
    qc = Blip2QFormerConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                            cross_attention_frequency=2, vocab_size=100, encoder_hidden_size=64)
    cfg = Blip2Config.from_vision_qformer_text_configs(vc, qc, _t5_config())
    cfg.num_query_tokens = 8
    torch.manual_seed(0)
    return Blip2ForConditionalGeneration(cfg).eval()


def mobile_sam_state_dict():
    """A seeded mobile_sam.pt of ``SamConfig.tiny_mobile_sam()``."""
    return seeded(S.expected_mobile_sam_checkpoint_keys(S.SamConfig.tiny_mobile_sam()), seed=2)


def _load(module):
    return lambda tree: load_jax_params_(module(), tree)


# name -> (state dict, JAX converter call, port converter call, the port's load of that tree)
CASES = {
    "blip2_itm": (hf_blip2_itm, lambda sd: JB.convert_hf_state_dict(sd, jax_blip2_itm_cfg()),
                  lambda sd: B.convert_hf_state_dict(sd, port_cfg(jax_blip2_itm_cfg())),
                  lambda t: B.BLIP2ITM.from_jax_params(port_cfg(jax_blip2_itm_cfg()), t, device="cpu")),
    "owl_vit": (hf_owl_vit, lambda sd: JO.convert_hf_owlvit(sd, JO.OwlViTDetConfig.tiny()),
                lambda sd: O.convert_hf_owlvit(sd, O.OwlViTDetConfig.tiny()),
                lambda t: O.OwlViTDetector.from_jax_params(O.OwlViTDetConfig.tiny(), t, device="cpu")),
    "tinyvit": (lambda: seeded(JTV.expected_mobile_sam_keys(JTV.TinyViTConfig.tiny()), seed=1),
                lambda sd: JTV.convert_mobile_sam_encoder(sd, JTV.TinyViTConfig.tiny()),
                lambda sd: TV.convert_mobile_sam_encoder(sd, TV.TinyViTConfig.tiny()),
                _load(lambda: TV.TinyViT(TV.TinyViTConfig.tiny(), device="cpu"))),
    "mobile_sam": (mobile_sam_state_dict, lambda sd: JS.convert_mobile_sam(sd, JS.SamConfig.tiny_mobile_sam()),
                   lambda sd: S.convert_mobile_sam(sd, S.SamConfig.tiny_mobile_sam()),
                   lambda t: S.SAM.from_jax_params(S.SamConfig.tiny_mobile_sam(), t, device="cpu")),
    "sam_vitdet": (hf_sam, lambda sd: JS.convert_hf_sam(sd, jax_sam_cfg()),
                   lambda sd: S.convert_hf_sam(sd, port_cfg(jax_sam_cfg())),
                   lambda t: S.SAM.from_jax_params(port_cfg(jax_sam_cfg()), t, device="cpu")),
    "swin": (hf_swin, lambda sd: JSW.convert_hf_swin(sd, JSW.SwinConfig.tiny_test()),
             lambda sd: SW.convert_hf_swin(sd, SW.SwinConfig.tiny_test()),
             _load(lambda: SW.SwinBackbone(SW.SwinConfig.tiny_test(), device="cpu"))),
    "grounding_dino": (hf_grounding_dino,
                       lambda sd: JG.convert_hf_grounding_dino(sd, JG.GroundingDinoJaxConfig.tiny_test()),
                       lambda sd: G.convert_hf_grounding_dino(sd, G.GroundingDinoConfig.tiny_test()),
                       lambda t: G.GroundingDinoDetector.from_jax_params(G.GroundingDinoConfig.tiny_test(), t,
                                                                         device="cpu")),
    "zoedepth": (lambda: hf_zoedepth(False), lambda sd: JZ.convert_hf_zoedepth(sd, jax_zoedepth_cfg(False)),
                 lambda sd: Z.convert_hf_zoedepth(sd, port_cfg(jax_zoedepth_cfg(False))),
                 lambda t: Z.ZoeDepth.from_jax_params(port_cfg(jax_zoedepth_cfg(False)), t, device="cpu")),
    "zoedepth_nk": (lambda: hf_zoedepth(True), lambda sd: JZ.convert_hf_zoedepth(sd, jax_zoedepth_cfg(True)),
                    lambda sd: Z.convert_hf_zoedepth(sd, port_cfg(jax_zoedepth_cfg(True))),
                    lambda t: Z.ZoeDepth.from_jax_params(port_cfg(jax_zoedepth_cfg(True)), t, device="cpu")),
    "t5": (hf_t5, lambda sd: JT.convert_hf_t5(sd, JT.T5Config.tiny()),
           lambda sd: T.convert_hf_t5(sd, T.T5Config.tiny()),
           lambda t: T.T5VQA.from_jax_params(T.T5Config.tiny(), t, device="cpu")),
    "blip2_t5": (hf_blip2_t5, lambda sd: JBV.convert_hf_blip2_t5(sd, JBV.BLIP2VQAConfig.tiny()),
                 lambda sd: BV.convert_hf_blip2_t5(sd, BV.BLIP2VQAConfig.tiny()),
                 lambda t: BV.BLIP2VQA.from_jax_params(BV.BLIP2VQAConfig.tiny(), *t, device="cpu")),
}


@pytest.fixture(scope="module")
def state_dicts():
    """name -> the case's state dict (numpy), each built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            src = CASES[name][0]()
            sd = src.state_dict() if isinstance(src, torch.nn.Module) else src
            cache[name] = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
        return cache[name]

    return get


def _flat(tree, prefix=""):
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}{i}/").items()}
    if hasattr(tree, "items"):
        return {k: v for key, t in tree.items() for k, v in _flat(t, f"{prefix}{key}/").items()}
    return {prefix: tree}


@pytest.mark.parametrize("name", list(CASES))
def test_converted_tree_equals_jax(state_dicts, name):
    """The same keys, dtypes and bits (10 converters; ZoeDepth single- and
    two-domain), and the port's tree loads into its module, strictly."""
    sd = state_dicts(name)
    want = {k: np.asarray(v) for k, v in _flat(CASES[name][1](sd)).items()}
    tree = CASES[name][2](sd)
    CASES[name][3](tree)
    got = _flat(tree)
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray), k
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(np.ascontiguousarray(g).view(np.uint8), np.ascontiguousarray(w).view(np.uint8),
                                      err_msg=k)


def test_key_tables_equal_jax():
    """The MobileSAM key tables: the encoder's equals JAX's in order; the
    whole checkpoint's is what JAX's converter reads."""
    for cfg in (TV.TinyViTConfig.tiny(), TV.TinyViTConfig()):
        jcfg = JTV.TinyViTConfig(**{**dataclasses.asdict(cfg), "compute_dtype": None})
        assert list(TV.expected_mobile_sam_keys(cfg).items()) == list(JTV.expected_mobile_sam_keys(jcfg).items())
    sd = mobile_sam_state_dict()
    jcfg = JS.SamConfig.tiny_mobile_sam()
    JS.convert_mobile_sam(sd, jcfg)
    for k in sd:  # each key is read: without it the converter fails
        with pytest.raises(KeyError):
            JS.convert_mobile_sam({n: v for n, v in sd.items() if n != k}, jcfg)


# ---------------------------------------------------------------------------
# forward parity of the full stack's three families from HF state dicts
# ---------------------------------------------------------------------------
def _itm_outputs(state_dicts):
    sd = state_dicts("blip2_itm")
    jcfg = jax_blip2_itm_cfg()
    jm, tm = JB.BLIP2ITM(jcfg, JB.convert_hf_state_dict(sd, jcfg)), B.BLIP2ITM.from_jax_params(
        port_cfg(jcfg), B.convert_hf_state_dict(sd, port_cfg(jcfg)), device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    ids = rng.integers(0, 100, (3, 6)).astype(np.int32)
    mask = np.ones((3, 6), bool)
    mask[1, 4:] = False
    want = jm.cosine(jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask))
    got = tm.cosine(torch.from_numpy(imgs), torch.from_numpy(ids), torch.from_numpy(mask))
    return [(got, want)]


def _owl_outputs(state_dicts):
    sd = state_dicts("owl_vit")
    cfg = O.OwlViTDetConfig.tiny()
    jm = JO.OwlViTDetector(JO.OwlViTDetConfig.tiny(), JO.convert_hf_owlvit(sd, JO.OwlViTDetConfig.tiny()))
    tm = O.OwlViTDetector.from_jax_params(cfg, O.convert_hf_owlvit(sd, cfg), device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ids = np.zeros((3, 16), np.int32)
    mask = np.zeros((3, 16), bool)
    for r, n in enumerate((5, 8, 3)):
        ids[r, :n] = rng.integers(1, 99, n)
        ids[r, n - 1] = 99  # end of text: the highest id, as CLIP's
        mask[r, :n] = True
    want = jm.detect(jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask))
    got = tm.detect(torch.from_numpy(imgs), torch.from_numpy(ids), torch.from_numpy(mask))
    return list(zip(got, want))


def _mobile_sam_outputs(state_dicts):
    sd = state_dicts("mobile_sam")
    jm = JS.SAM(JS.SamConfig.tiny_mobile_sam(), JS.convert_mobile_sam(sd, JS.SamConfig.tiny_mobile_sam()))
    cfg = S.SamConfig.tiny_mobile_sam()
    tm = S.SAM.from_jax_params(cfg, S.convert_mobile_sam(sd, cfg), device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    boxes = np.array([[[0.1, 0.1, 0.6, 0.6], [0.05, 0.3, 0.5, 0.9]]] * 2, np.float32)
    want = JS.SAM._segment(jm.module, jm.params, jnp.asarray(imgs), jnp.asarray(boxes))
    with torch.no_grad():
        got = tm.module(torch.from_numpy(imgs), torch.from_numpy(boxes))
    return list(zip(got, want))


# family -> (outputs, rtol): each as its test file states it (atol F32_ATOL; SAM's with rtol too)
FAMILIES = {"blip2_itm": (_itm_outputs, 0.0), "owl_vit": (_owl_outputs, 0.0),
            "mobile_sam": (_mobile_sam_outputs, F32_ATOL)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_loaded_models_match_jax(state_dicts, family):
    outputs, rtol = FAMILIES[family]
    for got, want in outputs(state_dicts):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=rtol)


# ---------------------------------------------------------------------------
# every published config at full width, on meta
# ---------------------------------------------------------------------------
def _hf_itm(c):
    from transformers import Blip2Config, Blip2ForImageTextRetrieval

    cfg = Blip2Config(vision_config=_hf_vision(c.vit), qformer_config=_hf_qformer(c, True))
    cfg.num_query_tokens, cfg.image_text_hidden_size = c.qformer.num_queries, c.embed_dim
    return Blip2ForImageTextRetrieval(cfg)


def _hf_vision(v):
    return dict(hidden_size=v.width, intermediate_size=v.mlp_dim, num_hidden_layers=v.depth,
                num_attention_heads=v.heads, image_size=v.image_size, patch_size=v.patch_size)


def _hf_qformer(c, text_input):
    q = c.qformer
    return dict(hidden_size=q.hidden, num_hidden_layers=q.layers, num_attention_heads=q.heads,
                intermediate_size=q.intermediate, vocab_size=q.vocab_size,
                cross_attention_frequency=q.cross_attention_freq,
                max_position_embeddings=q.max_position, encoder_hidden_size=c.vit.width,
                use_qformer_text_input=text_input)


def _hf_t5(t):
    return dict(model_type="t5", vocab_size=t.vocab_size, d_model=t.d_model, d_kv=t.d_kv, d_ff=t.d_ff,
                num_heads=t.heads, num_layers=t.enc_layers, num_decoder_layers=t.dec_layers,
                feed_forward_proj="gated-gelu", tie_word_embeddings=False,
                relative_attention_num_buckets=t.rel_buckets, relative_attention_max_distance=t.rel_max_distance)


def _hf_vqa(c):
    from transformers import Blip2Config, Blip2ForConditionalGeneration

    cfg = Blip2Config(vision_config=_hf_vision(c.vit), qformer_config=_hf_qformer(c, False), text_config=_hf_t5(c.t5))
    cfg.num_query_tokens = c.qformer.num_queries
    return Blip2ForConditionalGeneration(cfg)


def _hf_owl(c):
    from transformers import OwlViTConfig, OwlViTForObjectDetection

    t, v = c.text, c.vision
    cfg = OwlViTConfig(
        text_config=dict(hidden_size=t.hidden, intermediate_size=t.mlp_dim, num_hidden_layers=t.layers,
                         num_attention_heads=t.heads, vocab_size=t.vocab_size, max_position_embeddings=t.max_position),
        vision_config=dict(hidden_size=v.hidden, intermediate_size=v.mlp_dim, num_hidden_layers=v.layers,
                           num_attention_heads=v.heads, image_size=v.image_size, patch_size=v.patch_size),
        projection_dim=c.projection_dim)
    return OwlViTForObjectDetection(cfg)


def _hf_sam(c):
    from transformers import SamConfig as HFSamConfig, SamModel

    v, d = c.vision, c.decoder
    return SamModel(HFSamConfig(
        vision_config=dict(hidden_size=v.width, intermediate_size=v.mlp_dim, num_hidden_layers=v.depth,
                           num_attention_heads=v.heads, image_size=v.image_size, patch_size=v.patch_size,
                           global_attn_indexes=list(v.global_attn_indexes), window_size=v.window_size,
                           output_channels=v.out_channels, num_pos_feats=c.pe_dim),
        prompt_encoder_config=dict(hidden_size=d.hidden, image_size=v.image_size, patch_size=v.patch_size),
        mask_decoder_config=dict(hidden_size=d.hidden, num_hidden_layers=d.layers, num_attention_heads=d.heads,
                                 mlp_dim=d.mlp_dim, iou_head_depth=d.iou_head_depth,
                                 iou_head_hidden_dim=d.iou_head_hidden)))


def _hf_gdino(c):
    from transformers import GroundingDinoConfig, GroundingDinoForObjectDetection

    s, t = c.swin, c.text
    cfg = GroundingDinoConfig(
        backbone_config=dict(model_type="swin", patch_size=s.patch_size, embed_dim=s.embed_dim, depths=list(s.depths),
                             num_heads=list(s.heads), window_size=s.window,
                             out_features=[f"stage{i + 1}" for i in c.swin_out_stages]),
        text_config=dict(model_type="bert", hidden_size=t.hidden, num_hidden_layers=t.layers,
                         num_attention_heads=t.heads, intermediate_size=t.intermediate, vocab_size=t.vocab_size,
                         max_position_embeddings=t.max_position, type_vocab_size=t.type_vocab),
        d_model=c.d_model, encoder_layers=c.encoder_layers, decoder_layers=c.decoder_layers,
        encoder_attention_heads=c.encoder_heads, decoder_attention_heads=c.decoder_heads,
        encoder_ffn_dim=c.encoder_ffn, decoder_ffn_dim=c.decoder_ffn, num_queries=c.num_queries,
        num_feature_levels=c.num_feature_levels, max_text_len=c.max_text_len, encoder_n_points=c.encoder_n_points,
        decoder_n_points=c.decoder_n_points, disable_custom_kernels=True)
    return GroundingDinoForObjectDetection(cfg)


def _hf_zoe(c):
    from transformers import BeitConfig, ZoeDepthConfig, ZoeDepthForDepthEstimation

    b = c.beit
    bb = BeitConfig(image_size=b.image_size, patch_size=b.patch_size, num_hidden_layers=b.layers,
                    hidden_size=b.hidden_size, intermediate_size=b.intermediate, num_attention_heads=b.heads,
                    use_relative_position_bias=True, reshape_hidden_states=False,
                    out_features=[f"stage{i}" for i in b.out_indices])
    cfg = ZoeDepthConfig(
        backbone_config=bb, neck_hidden_sizes=list(c.neck_hidden_sizes), fusion_hidden_size=c.fusion_hidden_size,
        num_relative_features=c.num_relative_features, bottleneck_features=c.bottleneck_features,
        num_attractors=list(c.num_attractors), bin_embedding_dim=c.bin_embedding_dim,
        bin_configurations=[dict(name=n, n_bins=k, min_depth=lo, max_depth=hi)
                            for n, k, lo, hi in c.bin_configurations],
        num_patch_transformer_layers=c.patch_transformer_layers,
        patch_transformer_hidden_size=c.patch_transformer_hidden,
        patch_transformer_intermediate_size=c.patch_transformer_intermediate,
        patch_transformer_num_attention_heads=c.patch_transformer_heads)
    return ZoeDepthForDepthEstimation(cfg)


def _mobile_sam_shapes(c):
    return S.expected_mobile_sam_checkpoint_keys(c)


# name -> (the published config, its HF model (or key -> shape table), the converter, the port module(s))
PUBLISHED = {
    "blip2_itm": (B.BLIP2ITMConfig(), _hf_itm, B.convert_hf_state_dict, lambda c: [B.BLIP2ITMModule(c, device="meta")]),
    "owl_vit": (O.OwlViTDetConfig(), _hf_owl, O.convert_hf_owlvit,
                lambda c: [O.OwlViTDetectionModule(c, device="meta")]),
    "sam_vit_base": (S.SamConfig(), _hf_sam, S.convert_hf_sam, lambda c: [S.SamModule(c, device="meta")]),
    "mobile_sam": (S.SamConfig.mobile_sam(), _mobile_sam_shapes, S.convert_mobile_sam,
                   lambda c: [S.SamModule(c, device="meta")]),
    "grounding_dino": (G.GroundingDinoConfig(), _hf_gdino, G.convert_hf_grounding_dino,
                       lambda c: [G.GroundingDinoModule(c, device="meta")]),
    "zoedepth_n": (Z.ZoeDepthConfig(), _hf_zoe, lambda sd, c: Z.without_unused_residual(Z.convert_hf_zoedepth(sd, c)),
                   lambda c: [Z.ZoeDepthModule(c, device="meta")]),
    "zoedepth_nk": (Z.ZoeDepthConfig.nk(), _hf_zoe,
                    lambda sd, c: Z.without_unused_residual(Z.convert_hf_zoedepth(sd, c)),
                    lambda c: [Z.ZoeDepthModule(c, device="meta")]),
    "blip2_vqa": (BV.BLIP2VQAConfig(), _hf_vqa, BV.convert_hf_blip2_t5,
                  lambda c: [BV.BLIP2VisualPrefixModule(c, device="meta"), T.T5Module(c.t5, device="meta")]),
    "blip2_flan_t5_xl": (BV.BLIP2VQAConfig.production(), _hf_vqa, BV.convert_hf_blip2_t5,
                         lambda c: [BV.BLIP2VisualPrefixModule(c, device="meta"), T.T5Module(c.t5, device="meta")]),
}


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_published_config_is_covered_at_full_width(name):
    cfg, hf, convert, modules = PUBLISHED[name]
    with torch.device("meta"):
        src = hf(cfg)
    shapes = src if isinstance(src, dict) else {k: tuple(v.shape) for k, v in src.state_dict().items()}
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, s) for k, s in shapes.items()}
    tracemalloc.start()
    try:
        trees = convert(sd, cfg)
        trees = trees if isinstance(trees, tuple) else (trees,)
        layouts = [{k: a.shape for k, a in port_layout(t).items()} for t in trees]
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < META_PEAK_BYTES, peak
    n = 0
    for layout, module in zip(layouts, modules(cfg)):
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert layout == want
        n += sum(int(np.prod(s)) for s in want.values())
    assert n > 5e6


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """Seven entries (ITM cast for serving, the rest f32) and a vocab,
    saved once: (path, the source wrappers)."""
    d = tmp_path_factory.mktemp("bundle")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(toy_vocab(["toilet", "chair"])) + "\n")
    itm = B.BLIP2ITM.init_random(B.BLIP2ITMConfig.tiny(), seed=0, device="cpu")
    cast_for_serving(itm.module)
    src = dict(itm=itm, detector=O.OwlViTDetector.init_random(O.OwlViTDetConfig.tiny(), seed=1, device="cpu"),
               sam=S.SAM.init_random(S.SamConfig.tiny_mobile_sam(), seed=2, device="cpu"),
               gdino=G.GroundingDinoDetector.init_random(G.GroundingDinoConfig.tiny_test(), seed=3, device="cpu"),
               zoedepth=Z.ZoeDepth.init_random(seed=4, device="cpu"),
               vqa=BV.BLIP2VQA.init_random(BV.BLIP2VQAConfig.tiny(), seed=5, device="cpu"))
    return W.save_bundle(str(d / "b"), **src, vocab_file=str(vocab)), src


def _modules(models, name):
    if name == "vqa_t5":
        return models["vqa"].t5.module
    return models["vqa" if name == "vqa_bridge" else name].module


@pytest.mark.parametrize("name", ["itm", "detector", "sam", "gdino", "zoedepth", "vqa_bridge", "vqa_t5"])
def test_bundle_round_trip(bundle, name):
    path, src = bundle
    b = W.load_bundle(path, device="cpu")
    key = "vqa" if name.startswith("vqa") else name
    assert getattr(b, key).cfg == src[key].cfg
    want, got = _modules(src, name).state_dict(), _modules(vars(b), name).state_dict()
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].device.type == "cpu", k
        assert torch.equal(got[k], w), k
    assert getattr(b, key).module.training is False


def test_bundle_vocab_and_cast_on_load(bundle):
    path, src = bundle
    b = W.load_bundle(path, dtype=torch.bfloat16, device="cpu")
    assert b.tokenizer.vocab == toy_vocab(["toilet", "chair"]) and b.tokenizer.max_len == 32
    assert b.tokenizer.encode("toilet") == [2, b.tokenizer.vocab["toilet"], 3]
    assert b.detector.module.box_head.dense0.weight.dtype == torch.bfloat16
    assert b.detector.module.post_ln.weight.dtype == torch.float32  # norms keep f32
    assert b.vqa.t5.module.lm_head.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["itm", "detector", "sam", "gdino", "zoedepth", "vqa"])
def test_manifest_equals_jax(bundle, name):
    """The port's manifest is JAX's ``_cfg_to_dict`` of the same configs,
    class names mapped."""
    path, _ = bundle
    jax_cfgs = dict(itm=JB.BLIP2ITMConfig.tiny(), detector=JO.OwlViTDetConfig.tiny(),
                    sam=JS.SamConfig.tiny_mobile_sam(),
                    gdino=JG.GroundingDinoJaxConfig.tiny_test(), zoedepth=JZ.ZoeDepthJaxConfig.tiny_test(),
                    vqa=JBV.BLIP2VQAConfig.tiny())
    manifest = json.loads((W.Path(path) / "manifest.json").read_text())
    want = json.loads(json.dumps(JW._cfg_to_dict(jax_cfgs[name])))
    want = json.loads(json.dumps(want).replace('"GroundingDinoJaxConfig"', '"GroundingDinoConfig"')
                      .replace('"ZoeDepthJaxConfig"', '"ZoeDepthConfig"').replace('"BeitConfigJx"', '"BeitConfig"'))
    assert manifest["models"][name] == want
    assert manifest["vocab"] == "vocab.txt"


CFG = VLFMConfig(camera=CameraConfig(height=48, width=64), map_size=512, max_frontiers=16, max_frontier_cells=256,
                 object_map_slots=8, object_map_points_per_slot=128, max_detections_per_frame=4)
SPEC = GridSpec2D(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)


def test_full_stack_from_bundle_serves_as_in_memory(bundle):
    """Two dispatches of two lanes through the bundle-served stack and
    through the stack over the in-memory models, with the bundle's
    vocabulary: the same actions, flags, goals and states, bit for bit."""
    path, src = bundle
    served = W.full_stack_from_bundle(CFG, path, device="cpu")
    assert served.tokenizer.max_len == 16  # the tiny OWL-ViT's position table
    direct = FS.FullStackPerception(CFG, itm=src["itm"], detector=src["detector"], sam=src["sam"], device="cpu")
    direct.tokenizer = direct.engine.tokenizer = served.tokenizer
    steps = [p.make_fused_step("greedy", SPEC, CFG, "toilet") for p in (served, direct)]
    states = [ITM.create_state(SPEC, CFG, batch=2, device="cpu") for _ in steps]
    envs = [FakeObjectNavEnv(open_room_plan(seed=s), EnvConfig(width=64, height=48)) for s in (1, 2)]
    obs = [e.reset() for e in envs]
    for k in range(2):
        inputs = (np.zeros(2, np.uint8), np.stack([o["depth"] for o in obs]),
                  np.array([o["heading"] for o in obs], np.float32), np.stack([o["robot_xy"] for o in obs]),
                  np.stack([o["rgb"] for o in obs]), np.arange(2, dtype=np.int32), np.full(2, k, np.int32))
        outs = []
        for i, step in enumerate(steps):
            *out, states[i] = step(states[i], None, *inputs)
            outs.append(out)
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        obs = [e.step(int(a)) for e, a in zip(envs, outs[0][0])]
    flat = [[t for f in s for t in (f if isinstance(f, tuple) else (f,))] for s in states]
    assert all(torch.equal(x, y) for x, y in zip(*flat))


def _jax_bundle(tmp_path):
    """A directory in the JAX package's layout: its manifest, an orbax tree."""
    d = tmp_path / "jax_bundle"
    (d / "itm").mkdir(parents=True)
    (d / "itm" / "_METADATA").write_text("{}")
    (d / "manifest.json").write_text(json.dumps({"models": {"itm": JW._cfg_to_dict(JB.BLIP2ITMConfig.tiny())}}))
    return d


def test_jax_bundle_is_refused(tmp_path):
    with pytest.raises(W.BundleError, match="python -m vlfm_tpu_torch.convert_checkpoints"):
        W.load_bundle(str(_jax_bundle(tmp_path)), device="cpu")
    with pytest.raises(W.BundleError, match="no manifest.json"):
        W.full_stack_from_bundle(CFG, str(tmp_path), device="cpu")


def test_run_py_refuses_a_jax_bundle(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run", "--cpu", "--backend", "synthetic", "--farm", "2",
                                      "--weights-dir", str(_jax_bundle(tmp_path))])
    with pytest.raises(SystemExit, match="orbax tree.*python -m vlfm_tpu_torch.convert_checkpoints"):
        RUN.main()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mobile_sam_checkpoint():
    """A full-width mobile_sam.pt's state dict with seeded values."""
    return seeded(S.expected_mobile_sam_checkpoint_keys(S.SamConfig.mobile_sam()), seed=3)


@pytest.mark.parametrize("fmt,f32", [("pt", False), ("safetensors", False), ("pt", True)])
def test_convert_checkpoints_cli(mobile_sam_checkpoint, tmp_path, capsys, fmt, f32):
    """MobileSAM at full width through the converter CLI: the bundle loads,
    its SAM equals the converter's tree loaded and cast."""
    sd = mobile_sam_checkpoint
    src = tmp_path / f"mobile_sam.{fmt}"
    if fmt == "pt":
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, src)
    else:
        from safetensors.numpy import save_file

        save_file(sd, str(src))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(toy_vocab()) + "\n")
    CONVERT.main(["--out", str(tmp_path / "b"), "--mobile-sam", str(src), "--vocab", str(vocab)]
                 + (["--f32"] if f32 else []))
    assert "converted MobileSAM" in capsys.readouterr().out
    b = W.load_bundle(str(tmp_path / "b"), device="cpu")
    assert b.itm is None and b.detector is None and b.tokenizer.vocab == toy_vocab()
    cfg = S.SamConfig.mobile_sam()
    assert b.sam.cfg == cfg
    want = S.SAM.from_jax_params(cfg, S.convert_mobile_sam(sd, cfg), device="cpu")
    if not f32:
        cast_for_serving(want.module)
    got = b.sam.module.state_dict()
    for k, w in want.module.state_dict().items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert (got["vision.stage0_block0.conv1.conv.weight"].dtype == torch.float32) == f32


def test_run_py_serves_a_bundle_on_the_habitat_mock(bundle, tmp_path, monkeypatch, capsys):
    """``run.py --backend habitat --cpu --weights-dir``: the habitat loop over
    the bundle's models, on tests/mock_habitat.py."""
    path, _ = bundle
    mock_habitat.install()
    try:
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps({"camera": {"height": 48, "width": 64}, "map_size": 512, "max_frontiers": 16,
                                   "max_frontier_cells": 256, "object_map_slots": 8,
                                   "object_map_points_per_slot": 128, "num_init_turns": 3}))
        served = []
        monkeypatch.setattr(W, "load_bundle", lambda *a, _f=W.load_bundle, **k: served.append(a) or _f(*a, **k))
        monkeypatch.setattr(sys, "argv", ["run", "--backend", "habitat", "--episodes", "1", "--config", str(cfg),
                                          "--cpu", "--weights-dir", path])
        RUN.main()
    finally:
        mock_habitat.uninstall()
    out = capsys.readouterr().out
    agg = json.loads(out[out.index("{"):])
    assert agg["episodes"] == 1 and agg["avg_steps"] > 0
    assert served == [(path,)]
