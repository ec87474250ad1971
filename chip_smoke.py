"""Drive vlfm_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. device: require CUDA, print the card, its power limit and versions,
     turn TF32 off;
  1. build the CUDA kernels from ``vlfm_tpu_torch/csrc`` (nvcc, sm_90a);
  2. LayerNorm kernel (K1) against its plain version at the main path's
     shapes, with CUDA-event timings of both and of ``F.layer_norm``, and
     the launch floor (an empty kernel, timed by the same method) beside
     K1 and ``F.layer_norm`` at the robot path's B=1 shapes; K1's fused
     entry (``add_layer_norm``: the residual add and the norm in one
     launch) at its sites' shapes, y within one bf16 ulp of its plain
     version and bit-equal to the add then K1, the kept sum bit-equal to
     ``x + h``, timed beside its plain version, the add then K1 (the route
     it replaced) and the add then ``F.layer_norm``; the host's cost per
     call of each form;
  3. attention kernel (K3) against its plain version: every variant at the
     ViT-g shape (32, 16, 257, 88) in bf16, the main path's layout (q, k, v
     as views of the fused qkv projection) at B=32 and at the spin's 12
     views, the CPU tests' ragged shapes in f32 and a 1024-token case, each
     with the kernel body it took; CUDA-event timings of the kernel, the
     plain version and ``scaled_dot_product_attention``, the bound, and the
     replaced design's time (``PARENT_K3_MS``);
  4. tiny BLIP2-ITM: the same weights on the CPU (plain versions) and on
     the card (K1, K3) give the same cosines;
  5. tiny obstacle map: the same spin frames update a small map on the CPU
     and on the card; the grids agree but for cone-edge flips, and the
     frontiers agree (the maps are batch-first; phases 5-8 run one lane);
  6. main path at full width: BLIP2-ITM (EVA ViT-g/14 + Q-Former, random
     bf16 weights) scores a 12-view spin of the synthetic environment; each
     view is one policy step (greedy controller, no detections: the
     obstacle, value and object maps), the last view the first EXPLORE
     step, whose frontier choice and greedy action are checked. K1's and
     K3's launches are counted over this run;
  7. value-map check: injected cosines that favour view 7 must make the
     policy pick a frontier inside view 7's field of view;
  8. timings: full-width ITM scoring per 32-image batch, the spin step
     (ITM and 12 policy steps) whole and its obstacle-map part alone;
  9. the MBConv chain kernel (K2) against its plain version at the detection
     path's shapes and at the CPU tests' ragged ones, each with the kernel
     body it took, with CUDA-event timings of both and the replaced design's
     time (``PARENT_K2_MS``);
 10. tiny detection pipeline (OWL-ViT -> COCO route -> gated MobileSAM):
     the same weights on the CPU (plain versions) and on the card (K1, K2)
     give the same boxes, scores and validity, and masks within a flip
     bound;
 11. the detection path at full width: OWL-ViT base-32 and MobileSAM
     (TinyViT-5M at 1024 px), random bf16 weights, on 8 spin frames, for a
     COCO target (both routes) and a non-COCO target at threshold 0 (every
     frame detects, so gated SAM runs all its passes); K1 and K2 launches
     are counted over this run; gated masks must match ungated ones;
 12. full-width detection timings: one pipeline call at B=8 and its parts;
     then the fused route's equivalence: ViT-g at B=8 and B=1 and the
     Q-Former's query branch on each, and one OWL-ViT detect at B=8 over
     the COCO prompts, through the models (every add before a norm in
     ``add_layer_norm``) and through an unfused composition written out
     here (a PyTorch add, then K1), bit for bit, with K1's launches and
     the fused ones counted; every path below prints its fused K1 share;
 13. the deformable gather kernel (K4) against its plain version at the
     GroundingDINO encoder's shape (B=8, Q = S = 13,294 over four levels)
     in the main path's f32 and in bf16 with grids over [-1.5, 1.5], in
     f32 with local grids (each token's centre plus N(0, 1)-pixel offsets
     per level, as the encoder samples), at the decoder's (Q = 900, grids
     from reference boxes) and at ragged f32 and bf16 shapes, some grids at
     +-1e6; each case's launch plan; CUDA-event timings of the kernel, the
     plain version and the grid_sample formulation, the bound, and the
     replaced design's time (``PARENT_K4_MS``);
 14. tiny GroundingDINO pipeline (GroundingDINO -> gated MobileSAM): the
     same weights on the CPU and on the card (K4 4 times per detect call)
     give the same boxes, scores, validity and classes, and masks within a
     flip bound;
 15. the GroundingDINO detection path at full width: GroundingDINO
     SwinT-OGC (Swin-T at 800 px, BERT-base, 900 queries, 256 tokens,
     random bf16 weights) as the pipeline's open-vocabulary detector, the
     OWL-ViT COCO route of phase 11, gated MobileSAM, on the 8 spin frames;
     a non-COCO target at the config threshold and at 0, and a COCO
     target; K4 launches 12 times per GroundingDINO detect call;
 16. GroundingDINO timings: one detect call at B=8 (wall, and device time
     under torch.profiler with K4's share) and one pipeline call;
 17. the batched spin at full width: 8 lanes (spins of two_room_plan seeds
     0-7, 12 views each), ITM cosines for the 96 frames in calls of 32 (K1,
     K3), per view one batched policy step (greedy), the window helpers
     under set_sync_debug_mode("error"); each lane equals a B=1 run bit for
     bit; launches, host syncs, wall and device time of the obstacle-map
     update and of the step at B=1 and B=8, the step adding no host sync;
 18. the object map at full width: phase 11's non-COCO call at threshold 0
     gives (8, 8, 480, 640) masks (K1, K2); update_objects on the 8 lanes
     (64 slots x 512 points, keys fold_in(PRNGKey(lane), step), where lane
     i holds view i of the spin, taken at step i) equals each lane alone;
     cursors count the accepted detections; timings. Random SAM weights
     give speckle that the mask erosion clears, so that case must accept
     nothing, and the same detections' boxes, as masks, run the case where
     points are accepted;
 19. batched closed-loop episodes at full width: a full-width PointNav
     (GN ResNet-18 at 224x224, 2x512 LSTM, random f32 weights from seed 0)
     and 8 lanes of two_room_plan seeds 0-7 at 640x480 for 30 steps: per
     step ITM on the 8 frames (K1, K3), the oracle target mask as detection
     0, one batched step (v2, PointNav), one action per lane (a finished
     lane idles). PointNav's random weights only turn, so after the spin
     the environments steer by the greedy rule toward step's goal (step's
     STOPs kept) and the maps are a moving agent's. Every lane leaves
     INITIALIZE after 12 steps, one reaches EXPLORE with a frontier, one
     moves, the ITM cosines are finite, and each equals a B=1 replay of its recorded
     inputs (maps, frontiers, object-map slots, modes bit for bit; goals
     and points within 1e-5 m; PointNav's logits and h/c within 1e-4;
     actions but at near ties, which are counted); the step and ITM + step
     timed at B=8 and B=1 (wall, device time, idle share, launches, host
     syncs, env-steps/s), the step adding no host sync to its obstacle
     update's, and PointNav's act alone; then run_episodes_recycled (16
     open_room_plan episodes on 8 lanes, greedy) against fresh
     run_episode runs on the card;
 20. the full stack at full width: FullStackPerception over phase 6's
     BLIP2-ITM, phase 11's OWL-ViT (COCO route, the config's thresholds)
     and MobileSAM gated at 2 frames, and phase 19's PointNav; 8 lanes of
     two_room_plan seeds 0-7 at 640x480 for 30 steps through
     make_fused_step with a packed layout (one pinned copy in, one (8, 4)
     read back per step; past the spin the environments steer by the
     greedy rule toward the returned goal); the frames with a detection and
     the SAM passes; K1, K2 and K3 counted per run and per step; the same
     30 steps' recorded inputs through the unpacked signature give every
     lane's actions, detected flags and goals bit for bit; one fused
     dispatch and ``batch`` alone timed at B=8 and B=1 (wall, device time,
     idle share, launches, host syncs, env-steps/s, bytes per dispatch);
     then run_episodes_farm (2 spawned sim workers over the shared-memory
     ring, one dispatch over all 8 lanes) on phase 19's 16 open_room_plan
     episodes, oracle-scored and equal to phase 19's run_episodes_recycled
     field for field, and with the full stack's perception on the first
     FULL_FARM_EPISODES of them (at most FULL_FARM_STEPS steps an episode,
     each past the spin), once with f32
     full-size records and once with the JAX bench's compressed transport
     (u16 half-size depth, half-size RGB, brought back to the camera grid
     on the card); all finish (env-steps/s, bytes put, the driver's time
     by phase);
 21. the VQA veto: (a) a tiny BLIP2VQA and its veto, card against CPU (the
     bucket tables equal, the prefix and first-token logits within 1e-3,
     tokens and vetoes equal off near ties); (b) BLIP-2 flan-T5-XL at full
     width (EVA ViT-g, the Q-Former, flan-t5-xl; random bf16 weights under
     cast_for_serving) vetoing 8 box-mask slots on each of the 8 spin
     frames at capacity 8 and 4 answer tokens, with 8 valid slots (1 pass)
     and 32 (4 passes): K1 and K3 launches per pass (110 and 39), the gated
     result against the dense one (first-token logits within
     VQA_LOGIT_ATOL, vetoes equal off near ties, which are counted), and
     each density timed (wall, device, idle, launches, host syncs); (c) the
     full stack with cfg.use_vqa (veto capacity 8) on 8 lanes for VQA_STEPS
     packed fused dispatches (K1, K2, K3 against the SAM and veto passes),
     held bit for bit to the unpacked signature; one dispatch with the veto
     timed beside one without it; run_episodes_farm with the veto on 8
     open_room_plan episodes of VQA_FARM_STEPS steps;
 22. ZoeDepth: (a) tiny NYU and NK, card against CPU; (b) ZoeD_NK at full
     width (BEiT-L/16 at 384 px) on the 8 spin frames at 640x480: each lane
     equals its B=1 run within ZOE_LANE_ATOL, depth in [0, 1], timed at
     B=1 and B=8; (c) FullStackPerception with all-ones depth infers depth,
     and with the sensor's depth returns the same object;
 23. PointNav behaviour cloning: (a) one batch of ``bc_loss_fn`` (B=2,
     T=6, 48x64 depth) and its backward on the card against the CPU under
     exact_f32 (loss, accuracy, every gradient); (b) fit_pointnav_to_greedy
     at the JAX bench's setting (bench.py:932-936: 16 episodes, 224x224
     depth through the u16 half-size seam, 150 Adam steps at batch 8):
     rollout and training seconds, device ms per Adam step, the teacher
     accuracy (above 0.85); (c) run_episodes_farm with the fitted network
     producing every PointNav action at the bench's composition
     (bench.py:938-952: 16 lanes, 2 workers, open_room_plan seeds
     400-415, 120 steps, u16 half-size depth, oracle perception) beside the
     greedy controller on the same episodes: success rate (above 0) and
     env-steps/s;
 24. the Habitat-protocol loop at full width: habitat_eval.evaluate over
     FakeHabitatEnv on 2 two_room_plan episodes at 640x480 of at most 40
     steps, HabitatVLFMAgent (v2, phase 23's fitted PointNav) over
     FullStackPerception with phase 20's models, logs and videos in a
     temporary directory: K1, K2 and K3 launches per act, the logs'
     analyze_logs summary against the results, one video frame per step
     but the last; one act at B=1 timed (wall, device, idle, launches,
     host syncs); then ``python -m vlfm_tpu_torch.run --backend synthetic
     --episodes 2 --max-steps 40`` and ``python -m
     vlfm_tpu_torch.runner.demo --episodes 1`` as subprocesses, each
     exiting 0 with its JSON;
 25. the robot path at full width, B=1: FakeRobot(seed=0) ->
     ObjectNavEnv (all body cameras for 10 steps) -> RealityITMPolicyV2
     (v2, a continuous PointNav at 224x224) with hooks over phase 20's
     models (BLIP2-ITM cosines; OWL-ViT with the COCO route for "toilet",
     MobileSAM gated at 2) and phase 22's ZoeD_NK, 24 actions (a stop
     starts a new episode): the 8 arm yaws with the base still, finite
     actions, ZoeD_NK exactly on the steps with a detection, K1, K2 and K3
     counted; each step re-run on the CPU from the card's state before it
     and its recorded inputs (grids but for cone-edge flips, frontiers,
     value map, object map, actions); a checkpoint after step 12
     (``runner/checkpoint.py``) restored into a fresh policy fed the
     recorded hook outputs gives the same actions and maps; the value-map
     updates recorded (``mapping/value_map_io.py``) and replayed on the CPU
     against the same updates on the card; one get_action timed with and
     without a detection (wall, device, idle, launches, syncs;
     ``utils/profiling.StepTimer``) and by part (perception, ZoeD_NK, the
     six obstacle updates, the rest of ``reality_step``);
 26. the port's last modules: (a) the tiny ViT-det SAM (``SamConfig.tiny()``
     and ``tiny_sam_config()``), the same f32 weights on the CPU and on
     the card: embeddings, mask logits and iou, masks away from 0 with
     multimask output off and on, gated equal to ungated, no kernel
     launched; (b) sam-vit-base at full width (``SamConfig()``: the
     ViT-det encoder at 1024 px, 93.7 M parameters, random weights from
     seed 0 under ``cast_for_serving``): phase 11's pipeline on the 8 spin
     frames with it in place of MobileSAM (K1 counted, K2 must stay 0),
     gated at capacity 2 against ungated, each lane at B=8 against its
     B=1 run, and the encoder timed at B=1 and B=8 (wall, device, idle,
     launches, peak device memory); (c) phase 19's full-width PointNav at
     B=8 with ``deterministic=False``, both heads, 16 keys: the card's
     gumbel and normal draws bit-equal to the CPU's, the sampled actions
     equal off near ties (discrete) or within PN_ATOL scaled by the draw
     (continuous); (d) ``evaluate_semexp`` over ``FakeSemExpVecEnv``, one
     16-step episode with phase 24's agent and phase 20's models; (e)
     phase 20's oracle farm with ``sharding=episode_sharding(make_mesh(1))``
     equal to the unsharded farm field for field;
 27. the serving bundle: (a) ``save_bundle`` of phase 20's BLIP2-ITM,
     OWL-ViT and MobileSAM with the toy vocab, ``load_bundle`` onto the
     card (GiB and seconds per entry), every state dict bit-equal; (b) a
     full-width mobile_sam.pt (seeded) through ``python -m
     vlfm_tpu_torch.convert_checkpoints``, loaded onto the card equal to
     its converter's tree, segmenting phase 11's 8 frames (K2 counted);
     (c) ``full_stack_from_bundle`` replaying BUNDLE_STEPS of phase 20's
     B=8 packed dispatches bit for bit against FullStackPerception over the
     in-memory models with the bundle's vocabulary (outputs and state), K1,
     K2 and K3 per dispatch (214, 3 per SAM pass, 39), one dispatch timed;
     (d) ``python -m vlfm_tpu_torch.run --backend synthetic --farm 8
     --episodes 8 --max-steps 10 --weights-dir`` exiting 0 with its JSON;
 28. tensor parallelism over a (2, 2) mesh, ``make_mesh(devices=[cuda:0] *
     4, model_parallel=2)``, all four devices the one card: (a) phase 6's
     BLIP2-ITM through ``shard_params_tp`` (a copy per data row, every
     Dense a ``SplitDense`` over the row's 2 model columns) scores the 8
     frames of phase 11 split 4 + 4 over the data rows, one
     ``PerceptionEngine`` a row; 253 split Dense calls per row (ViT-g 39 x
     4, the Q-Former 12 x 6 + 6 x 4, vision_proj) and none whole, K1 and K3
     at twice one unsplit image call's (220 and 78), the cosines within
     TP_COS_ATOL of the unsplit B=8 call and vision_proj's output within
     TP_FEAT_RTOL of its (both differences and bit-equality printed), both
     calls timed (wall, device, idle, launches, host syncs, peak memory),
     and a planted fault (one SplitDense's shards swapped) failing that
     check; (b) phase 11's OWL-ViT split the same way, boxes and logits over
     the COCO prompts within TP_OWL_ATOL of the unsplit detect; (c) phase
     20's oracle farm with ``sharding=episode_sharding(mesh)`` on its first
     TP_FARM_EPISODES episodes equal to the unsharded farm field for field.

The last two lines of standard output are the kernels' JSON record and the
device JSON line. ``scripts/profile_torch_step.py`` breaks the time of
phases 6, 8 and 12 (and, with ``--gdino``, of phase 16) down by kernel.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from vlfm_tpu_torch.adapters.habitat import HabitatVLFMAgent
from vlfm_tpu_torch.adapters.semexp import FakeSemExpVecEnv, SemExpVLFMAgent, evaluate_semexp
from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.kernels.build import load_library
from vlfm_tpu_torch.mapping import object_map as OBJ
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping import value_map_io as VIO
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from vlfm_tpu_torch.models.blip2_itm import CLIP_MEAN as BLIP_MEAN, CLIP_STD as BLIP_STD
from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA, BLIP2VQAConfig
from vlfm_tpu_torch.models.t5_vqa import bucket_table
from vlfm_tpu_torch.models.zoedepth import ZoeDepth, ZoeDepthConfig
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vlfm_tpu_torch.models.coco_classes import COCO_CLASSES
from vlfm_tpu_torch.models.coco_detector import CocoDetector
from vlfm_tpu_torch.models.grounding_dino import (
    GroundingDinoConfig,
    GroundingDinoDetector,
    GroundingDinoQueryAdapter,
    deformable_attentions,
)
from vlfm_tpu_torch.models.owl_vit import CLIP_MEAN, CLIP_STD, OwlViTDetConfig, OwlViTDetector, box_bias, quick_gelu
from vlfm_tpu_torch.models.precision import cast_for_serving, exact_f32
from vlfm_tpu_torch.models.sam import SAM, SamConfig, SamVisionEncoder
from vlfm_tpu_torch.models.tinyvit import chain_launches
from vlfm_tpu_torch.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu_torch.ops.attention import attention, attention_plan, attention_ref, attention_tolerance, qkv_views
from vlfm_tpu_torch.ops.conv_fused import chain_plan, chain_tolerance, mbconv_chain, mbconv_chain_ref
from vlfm_tpu_torch.ops.deform_gather import deform_gather, deform_gather_ref, deform_gather_tolerance, plan_for
from vlfm_tpu_torch.ops import flood as FL
from vlfm_tpu_torch.ops.norms import add_layer_norm, add_layer_norm_ref, bf16_tolerance, layer_norm, layer_norm_ref
from vlfm_tpu_torch.ops import threefry
from vlfm_tpu_torch.ops.resize import resize_bilinear
from vlfm_tpu_torch.ops.windows import read_window, window_index, write_window
from vlfm_tpu_torch.parallel.detection_pipeline import DetectionPipeline, VQAVeto
from vlfm_tpu_torch.parallel.engine import PerceptionEngine
from vlfm_tpu_torch.models.pointnav import PointNavPolicy, PointNavState
from vlfm_tpu_torch.parallel.mesh import SplitDense, episode_sharding, make_mesh, shard_episode_batch, shard_params_tp
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.policy import reality as REAL
from vlfm_tpu_torch.policy.itm import TURN_LEFT, update_objects, update_obstacles
from vlfm_tpu_torch.reality.envs import ObjectNavEnv, RealityEnvConfig
from vlfm_tpu_torch.reality.robots import FakeRobot
from vlfm_tpu_torch.runner import imitation as IM
from vlfm_tpu_torch.runner import metrics as RM
from vlfm_tpu_torch.runner import packing
from vlfm_tpu_torch.runner.analyze_logs import load_logs, summarize
from vlfm_tpu_torch.runner.checkpoint import map_tensors, restore_pytree, save_pytree
from vlfm_tpu_torch.runner.episode_driver import read_back, run_episode, run_episodes_recycled, step_inputs
from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, open_room_plan, two_room_plan
from vlfm_tpu_torch.runner.full_stack import FullStackPerception, tiny_sam_config
from vlfm_tpu_torch.runner.habitat_eval import FakeHabitatEnv, evaluate
from vlfm_tpu_torch.runner.sim_farm import run_episodes_farm
from vlfm_tpu_torch.utils.geometry import rho_theta, xyz_yaw_to_tf_matrix
from vlfm_tpu_torch.utils.img import resize_area
from vlfm_tpu_torch.utils.profiling import StepTimer, counters, reset_counters

DEV = torch.device("cuda", 0)
TARGET = "chair"
SPIN_VIEWS = 12
HIGH_VIEW = 7
# Published peaks of one H100 SXM at its 700 W limit: HBM bytes/s, and dense
# operations/s by the operands' type (bf16 on the tensor cores, f32 outside
# them). A kernel's bound is the larger of its
# bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (rows, D, dtype, eps): ViT-g and the Q-Former query branch at B=32 (the
# timing batch), the ragged widths of the CPU tests, the shapes phase 4
# gives the kernel (ViT-g and query branch at 12 views, text branch at one
# prompt of 32 tokens), and those phase 9 gives it: OWL-ViT vision at 8
# frames (577 tokens before the head, 576 patches after it), OWL-ViT text at
# the 80 COCO prompts and at one prompt of 8 tokens; those phase 19's
# decision step gives it: ViT-g at its 8 lanes and at one lane; and those
# phase 20's full stack adds: the Q-Former's queries at 8 lanes and at one,
# OWL-ViT's vision at one frame.
LN_CASES = [
    (8224, 1408, torch.bfloat16, 1e-6),
    (1024, 768, torch.bfloat16, 1e-12),
    (7, 96, torch.float32, 1e-6),
    (1, 33, torch.float32, 1e-6),
    (12 * 257, 1408, torch.bfloat16, 1e-6),
    (12 * 32, 768, torch.bfloat16, 1e-12),
    (32, 768, torch.bfloat16, 1e-12),
    (8 * 577, 768, torch.bfloat16, 1e-5),
    (8 * 576, 768, torch.bfloat16, 1e-5),
    (80 * 8, 512, torch.bfloat16, 1e-5),
    (1 * 8, 512, torch.bfloat16, 1e-5),
    (8 * 257, 1408, torch.bfloat16, 1e-6),
    (1 * 257, 1408, torch.bfloat16, 1e-6),
    (8 * 32, 768, torch.bfloat16, 1e-12),
    (1 * 577, 768, torch.bfloat16, 1e-5),
    (1 * 576, 768, torch.bfloat16, 1e-5),
]
LN_ROBOT_SHAPES = ((257, 1408), (32, 768), (577, 768), (576, 768), (8, 512))  # phase 25's B=1 rows
# The fused entry (add_layer_norm) at its sites' shapes: (site, rows, rows
# of h (a position table repeats over the batch), D, dtype, eps, keep_sum:
# a pre-norm site keeps the sum as the next residual, a post-norm site and a
# last norm do not). The B=8 dispatch's ViT-g block first: it stands for
# the entry in the JSON line.
ADD_LN_CASES = [
    ("ViT-g block add, B=8 dispatch", 8 * 257, 8 * 257, 1408, torch.bfloat16, 1e-6, True),
    ("ViT-g block add, B=1 act", 257, 257, 1408, torch.bfloat16, 1e-6, True),
    ("ViT-g block add, B=32 ITM", 32 * 257, 32 * 257, 1408, torch.bfloat16, 1e-6, True),
    ("ViT-g position add, B=8", 8 * 257, 257, 1408, torch.bfloat16, 1e-6, True),
    ("ViT-g post_ln, B=8", 8 * 257, 8 * 257, 1408, torch.bfloat16, 1e-6, False),
    ("Q-Former post-norm, B=8", 8 * 32, 8 * 32, 768, torch.bfloat16, 1e-12, False),
    ("Q-Former post-norm, B=1", 32, 32, 768, torch.bfloat16, 1e-12, False),
    ("OWL-ViT vision layer add, B=8", 8 * 577, 8 * 577, 768, torch.bfloat16, 1e-5, True),
    ("OWL-ViT vision layer add, B=1", 577, 577, 768, torch.bfloat16, 1e-5, True),
    ("OWL-ViT text layer add, 80 COCO prompts", 80 * 8, 80 * 8, 512, torch.bfloat16, 1e-5, True),
    ("OWL-ViT text layer add, one prompt", 8, 8, 512, torch.bfloat16, 1e-5, True),
    ("OWL-ViT text position add, 80 prompts of 16 tokens", 80 * 16, 16, 512, torch.bfloat16, 1e-5, True),
]
HOST_CALLS = 200  # back-to-back calls per host-cost figure
LN_F32_ATOL = 2e-5  # bf16: ops.norms.bf16_tolerance, one bf16 ulp of plain
TINY_COS_ATOL = 1e-3
LAUNCHES_TEXT = 25  # Q-Former text branch: embed_ln + 12 x (self_ln, ffn_text_ln)
LAUNCHES_IMAGE = 110  # ViT-g 39 x 2 + post_ln, Q-Former 1 + 12 x 2 + 6 cross_ln
ATTN_LAUNCHES_IMAGE = 39  # K3 once per ViT-g block; the Q-Former keeps plain attention
# K1 launches that take the add before them into the launch (add_layer_norm):
# all but the Q-Former's embed_ln (its text embeddings' add is cast first;
# its queries have none).
FUSED_TEXT = LAUNCHES_TEXT - 1
FUSED_IMAGE = LAUNCHES_IMAGE - 1
ATTN_LAUNCHES_TEXT = 0
ATTN_SHAPE = (32, 16, 257, 88)  # ViT-g at B=32: batch, heads, tokens, head width
ATTN_SPIN_SHAPE = (12, 16, 257, 88)  # ViT-g at the spin's 12 views
# ViT-g in the decision step and the full stack's dispatch: 8 lanes and one lane
ATTN_STEP_SHAPES = ((8, 16, 257, 88), (1, 16, 257, 88))
# (variant, the TPU kernels it stands for, arguments, K stored transposed)
ATTN_VARIANTS = [
    ("max/probs", "K3a flash_attention_grouped, K3c flash_attention, diag_attn_core grouped",
     dict(clamp=None, normalize="probs"), False),
    ("max/output", "K3b flash_attention_grouped_v2, diag_attn_core grouped norm_after",
     dict(clamp=None, normalize="output"), False),
    ("clamp80/output/bf16-logits", "layers.attention_bf16_softmax",
     dict(clamp=80.0, normalize="output", round_logits=True), False),
    ("clamp60/output, K transposed", "diag_attn3 attn_kt, diag_attn_core max_free, diag_attn_pure pure_kernel",
     dict(clamp=60.0, normalize="output"), True),
    ("clamp60/output/bf16-logits, K transposed", "diag_attn3 attn_phased and attn_kt pexp16",
     dict(clamp=60.0, normalize="output", round_logits=True), True),
]
# The CPU tests' ragged shapes in f32 (two variants each) and 1024 tokens.
ATTN_RAGGED = [
    ((2, 2, 64, 32), torch.float32), ((1, 16, 257, 88), torch.float32), ((2, 4, 130, 16), torch.float32),
    ((2, 4, 1024, 64), torch.bfloat16),
]
# The K3 and K2 designs this version replaced (commit e23db96), timed by
# that commit's chip_smoke.py on one card in one session with this
# version's kernels; printed beside this version's times.
PARENT_CARD = "commit e23db96 on an NVIDIA H100 80GB HBM3, 700 W"
PARENT_K3_MS = {  # (case, shape) -> ms
    ("max/probs, qkv views (the main path)", ATTN_SHAPE): 0.5001,
    ("max/probs", ATTN_SHAPE): 0.4958,
    ("max/output", ATTN_SHAPE): 0.4476,
    ("clamp80/output/bf16-logits", ATTN_SHAPE): 0.3298,
    ("clamp60/output, K transposed", ATTN_SHAPE): 0.8987,
    ("clamp60/output/bf16-logits, K transposed", ATTN_SHAPE): 0.9022,
    ("max/probs", (2, 2, 64, 32)): 0.0342,
    ("clamp60/output, K transposed", (2, 2, 64, 32)): 0.0307,
    ("max/probs", (1, 16, 257, 88)): 0.1937,
    ("clamp60/output, K transposed", (1, 16, 257, 88)): 0.1764,
    ("max/probs", (2, 4, 130, 16)): 0.0597,
    ("clamp60/output, K transposed", (2, 4, 130, 16)): 0.0502,
    ("max/probs", (2, 4, 1024, 64)): 0.1723,
}
PARENT_K2_MS = {  # shape -> ms
    (8, 256, 256, 64): 2.4812, (2, 256, 256, 64): 0.6331, (8, 64, 64, 160): 0.6191, (2, 64, 64, 160): 0.1584,
    (2, 7, 9, 8): 0.0152, (1, 5, 11, 8): 0.0156,
}
TINY_MAP = dict(map_size=256, map_pad=64, width=160, height=120, views=6)
MAP_FLIPS = 1e-3  # cone-edge cells: atan2/cos differ in the last ulp between devices
FRONTIER_ATOL_M = 0.1  # two cells
# (shape NHWC, Ch, Cout, residual and final gelu, dtype): the detection
# path's K2 calls (stage-0 MBConv and the stride-1 merge into stage 3, at
# B=8 ungated, at one gated pass of 2 frames, and at one frame, the full
# stack's B=1 dispatch), then the CPU tests' ragged shapes.
CHAIN_CASES = [
    ((8, 256, 256, 64), 256, 64, True, torch.bfloat16),
    ((2, 256, 256, 64), 256, 64, True, torch.bfloat16),
    ((8, 64, 64, 160), 320, 320, False, torch.bfloat16),
    ((2, 64, 64, 160), 320, 320, False, torch.bfloat16),
    ((1, 256, 256, 64), 256, 64, True, torch.bfloat16),
    ((1, 64, 64, 160), 320, 320, False, torch.bfloat16),
    ((2, 7, 9, 8), 16, 8, True, torch.float32),
    ((1, 5, 11, 8), 16, 16, False, torch.float32),
]
DET_BATCH = 8
COCO_TARGET = "toilet"  # the canonical HM3D goal: a COCO class, so both routes run
OPEN_TARGET = "fireplace"  # not a COCO class
# OWL-ViT K1 launches: one vision pass is pre_ln + 12 x 2 + post_ln +
# merge_ln, one text encoding 12 x 2 + final_ln; a COCO target runs detect
# twice (80 COCO prompts, then the open-vocabulary retry), another target once.
LAUNCHES_DETECT = 27 + 25
FUSED_DETECT = LAUNCHES_DETECT - 2  # all but the vision pass's layer0.ln1 (after pre_ln) and merge_ln (after a product)
FUSED_STEP = FUSED_IMAGE + 2 * FUSED_DETECT  # a full-stack dispatch, a robot act: 209 of 214
TINY_BOX_ATOL = 1e-4
TINY_MASK_FLIPS = 1e-3  # f32: a pixel flips only where its logit is within ~1e-4 of 0
GATED_MASK_FLIPS = 1e-2  # bf16: cuBLAS picks other GEMM tilings at 2 and 8 frames
# GroundingDINO's four levels at 800 px: Swin-T stages 2-4 (strides 8, 16,
# 32) and the extra stride-2 conv, S = 13,294 tokens.
DEFORM_LEVELS = ((100, 100), (50, 50), (25, 25), (13, 13))
# (name, B, Q, nh, dh, levels, P, value dtype, weights dtype, grids): the
# encoder's self-attention (Q = S) in the main path's f32 (flax's promotion
# keeps GroundingDINO's streams f32 under bf16 weights) and in bf16 with
# uniform grids, in f32 with local grids, the decoder's cross-attention (900
# queries, grids from 4-d reference boxes), and the CPU tests' ragged shape
# in f32 and bf16.
DEFORM_CASES = [
    ("encoder, the main path's f32", 8, 13294, 8, 32, DEFORM_LEVELS, 4, torch.float32, torch.float32, "uniform"),
    ("encoder, bf16 value and weights", 8, 13294, 8, 32, DEFORM_LEVELS, 4, torch.bfloat16, torch.bfloat16, "uniform"),
    ("encoder, local grids", 8, 13294, 8, 32, DEFORM_LEVELS, 4, torch.float32, torch.float32, "local"),
    ("decoder, the main path's f32", 8, 900, 8, 32, DEFORM_LEVELS, 4, torch.float32, torch.float32, "boxes"),
    ("ragged f32", 1, 70, 2, 16, ((7, 9), (4, 5), (2, 3)), 3, torch.float32, torch.float32, "uniform"),
    ("ragged bf16", 1, 70, 2, 16, ((7, 9), (4, 5), (2, 3)), 3, torch.bfloat16, torch.float32, "uniform"),
]
# K4's first design (one warp per item; commit 717047f), timed on the same
# inputs in one run on one card, in turns with this version's kernel, by
# scripts/ab_deform_gather.py; printed beside this version's times.
PARENT_K4_CARD = "commit 717047f on an NVIDIA H100 80GB HBM3, 700 W"
PARENT_K4_MS = {  # case -> ms
    "encoder, the main path's f32": 1.3438, "encoder, bf16 value and weights": 1.3802,
    "encoder, local grids": 1.4307, "decoder, the main path's f32": 0.1240, "ragged f32": 0.0080,
    "ragged bf16": 0.0080,
}
FAR_SHARE = 0.01  # grids at +-1e6: far off every map
TINY_GDINO_BOX_ATOL = 1e-4
K4_PER_DETECT = deformable_attentions(GroundingDinoConfig())  # 6 encoder + 6 decoder layers
BATCH_LANES = 8  # phase 17: episodes in one batch
ITM_BATCH = 32  # phase 17: frames per ITM call
OBJ_POINT_ATOL = 1e-5  # metres: phase 18, B=8 against B=1
EPISODE_STEPS = 30  # phases 19-20: the 12-turn spin, then 18 steps
PN_ATOL = 1e-4  # phase 19: PointNav's logits and h/c, B=8 against B=1 (cuDNN picks its algorithms per batch)
FARM_EPISODES = 16  # phases 19-20: open_room_plan episodes on BATCH_LANES lanes
# phase 20: the full stack's farms run the first of the oracle farm's episodes, one per lane, each for
# the 12-turn spin and 8 steps past it (the oracle farm's run EPISODE_STEPS)
FULL_FARM_EPISODES = 8
FULL_FARM_STEPS = 20
FARM_WORKERS = 2  # phase 20: sim worker processes
SAM_CAPACITY = 2  # phase 20: gated SAM's frames per pass
VQA_CAPACITY = 8  # phases 21-22: veto slots per pass, 4 answer tokens (bench.py:565-575)
VQA_TOKENS = 4
VQA_DENSITIES = (8, 32)  # phase 21: valid slots of the 8 frames x 8 slots: one pass and four
TINY_VQA_ATOL = 1e-3  # phase 21: tiny f32 prefix and first-token logits, card against CPU
# Phase 21: first-token logits of a slot asked in a capacity-8 pass against
# the dense 64-slot batch (bf16 GEMM tilings follow the batch) must agree to
# VQA_LOGIT_ATOL; a slot whose top-2 margin is at most VQA_TIE is a near tie
# and may answer otherwise, and is counted.
VQA_LOGIT_ATOL = 0.05
VQA_TIE = 2 * VQA_LOGIT_ATOL
VQA_STEPS = 2  # phase 21: fused dispatches with the veto (in the spin)
VQA_FARM_EPISODES = 8  # phase 21: the veto's farm, open_room_plan episodes
VQA_FARM_STEPS = 2
TINY_ZOE_ATOL = 1e-4  # phase 22: tiny ZoeDepth's metric depth (m), card against CPU
ZOE_LANE_ATOL = 1e-4  # phase 22: normalised depth, a lane at B=8 against B=1 (cuDNN picks algorithms per batch)
# phase 23: behaviour cloning. (a) one batch of B=2, T=6 at 48x64, card against CPU under exact_f32: the loss
# within BC_LOSS_RTOL, each gradient within BC_GRAD_RTOL and BC_GRAD_ATOL times its tensor's largest entry (the
# CPU tests' tolerances against JAX: f32 sums in another order). (b) the JAX bench's fit (bench.py:932-936) and
# (c) its trained farm (bench.py:938-952): 16 lanes, 2 workers, seeds 400-415, 120 steps, u16 half-size depth.
BC_TINY_SHAPE = (48, 64)
BC_LOSS_RTOL = 1e-5
BC_GRAD_RTOL, BC_GRAD_ATOL = 1e-4, 1e-5
BC_FIT = dict(episodes=16, train_steps=150, batch=8, max_steps=40, transport="u16_half", seed=0)
BC_ENV_STEPS = 60
BC_ACCURACY = 0.85  # tests/test_imitation.py:69
BC_TIMED_STEPS = 5  # Adam steps under the profiler for the device ms per step
TRAINED_LANES = 16
TRAINED_SEEDS = list(range(400, 416))
TRAINED_ENV_STEPS = 120
# phase 24: the Habitat-protocol loop over FakeHabitatEnv at 640x480
HABITAT_EPISODES = 2
HABITAT_STEPS = 40  # phase 24: steps per episode, and the CLI run's
HABITAT_TARGET = "toilet"  # HM3D goal 3, FakeHabitatEnv's object category
CLI_TIMEOUT_S = 300
# phase 25: the robot path
REALITY_ACTIONS = 24
REALITY_TARGET = "toilet"
REALITY_CKPT_AFTER = 12  # actions before the checkpoint
REALITY_TIMED = 5  # get_action calls per timed median
REALITY_ACTION_ATOL = 1e-5  # angular, linear, rho, theta: the card's step against its CPU replay
REALITY_FRONTIER_ATOL_M = 1e-6  # where the step's grids agree bit for bit (else phase 5's FRONTIER_ATOL_M)
REALITY_VALUE_ATOL = 1e-5  # the value map: a step's replay, and a recording's replay (cone-edge cells aside)
REALITY_CKPT_ATOL = 1e-6  # the resumed run against the live one, should cuDNN break bit-equality
REALITY_CELLS = 6 * 288 * 288  # cells a step's six obstacle updates may touch (the flip allowance's base)
# phase 26
TINY_VITDET_RTOL = 1e-4  # tiny ViT-det SAM, f32, card against CPU: of the largest entry (iou absolute)
TINY_VITDET_MARGIN = 1e-3  # masks compared where |logit| exceeds this share of the largest
VITDET_LANE_RTOL = 1e-4  # sam-vit-base, a lane at B=8 against B=1 (f32 compute; cuBLAS tiles per batch)
STOCHASTIC_KEYS = 16
SEMEXP_STEPS = 16
# phase 27: the serving bundle
BUNDLE_STEPS = 6  # phase 20's recorded dispatches replayed through the bundle-served stack
BUNDLE_FARM = dict(lanes=8, episodes=8, steps=10)  # run.py --farm --weights-dir
TP_MESH = dict(devices=4, model_parallel=2)  # phase 28: 2 data rows x 2 model columns, all on the one card
TP_DENSE_IMAGE = 39 * 4 + 12 * 6 + 6 * 4 + 1  # Dense calls of one image call: ViT-g, the Q-Former, vision_proj
# Phase 28 (a): the split ITM against the unsplit call. With random weights
# the cosines are about 1e-2 in size; on the card the split moves them by
# 4.9e-4 and vision_proj's output (the image embeddings before the norm) by
# 8.9e-3 in L2 norm relative to the unsplit one's, and one ViT-g
# SplitDense's shards swapped (the planted fault, which must fail) by 3.5e-3
# and 1.4e-1. The limits lie between.
TP_COS_ATOL = 2e-3
TP_FEAT_RTOL = 2e-2
TP_OWL_ATOL = 3e-2  # phase 28 (b): OWL-ViT split against unsplit, bf16 serving (tests/test_torch_blip2_itm.py's)
TP_FARM_EPISODES = 8  # phase 28 (c): one round of BATCH_LANES lanes (recycling over the mesh: test_torch_mesh.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def counted(name: str) -> int:
    """The counter ``name`` (``utils/profiling.py``): ``K1.launches``,
    ``K1.fused_launches``, ``K2.launches``, ``K3.launches``, ``K4.launches``;
    0 where nothing counted since ``reset_counters()``."""
    return counters().get(name, 0)


def with_fused(launches: dict, label: str, want: int | None = None) -> dict:
    """``launches`` and ``layer_norm_fused``: how many of the path's K1
    launches (counts set to 0 before it) took the add before them into the
    launch (``add_layer_norm``), checked against ``want`` where the path's
    model calls fix it."""
    fused = counted("K1.fused_launches")
    log(f"[{label}] K1 fused with the add before it: {fused} of {launches['layer_norm']} launches"
        + ("" if want is None else f" (expect {want})"))
    check(want is None or fused == want, f"{label}: fused K1 launch count")
    return {**launches, "layer_norm_fused": fused}


# --- phase 0 -----------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    torch.cuda.set_device(DEV)
    return smi


# --- phase 1 -----------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    load_library()
    log(f"[build] csrc/*.cu -> sm_90a in {time.perf_counter() - t0:.2f} s")


# --- phase 2 -----------------------------------------------------------------
def _median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events around each of
    ``reps`` calls. A spin kernel holds the card first, so the host queues
    all calls (and its Python overhead) before the first one starts and the
    events time the device's work alone."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(starts, ends)]))


def wall_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time of one call that ends in a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over HBM's rate and the operations over the peak rate for ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_floor_ms() -> float:
    """The event-to-event time of an empty kernel (a zero-cycle spin), by
    ``_median_ms``: the least time any launch shows by this method."""
    return _median_ms(lambda: torch.cuda._sleep(0))


def ln_inputs(rows: int, d: int, dt: torch.dtype, gen) -> tuple:
    x = (torch.randn(rows, d, generator=gen, device=DEV) * 2.0 + 0.5).to(dt)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=DEV)
    bias = 0.1 * torch.randn(d, generator=gen, device=DEV)
    return x, scale, bias


def ln_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool, str]:
    """(max abs error, within tolerance, the tolerance): f32 LN_F32_ATOL,
    bf16 one bf16 ulp of the plain result."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float(err.max()), float(err.max()) <= LN_F32_ATOL, f"max abs <= {LN_F32_ATOL}"
    ratio = float((err / bf16_tolerance(want)).max())
    return float(err.max()), ratio <= 1.0, f"each <= 1 bf16 ulp of plain, floor 1e-6 (max {ratio:.2f} of that)"


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Wall microseconds per call over ``calls`` back-to-back calls and one
    synchronise: the host's cost of issuing a call wherever that exceeds
    the device's time for it (every shape here at B=1)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def phase_layer_norm() -> tuple[dict, dict]:
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows_out = []
    floor = launch_floor_ms()
    for rows, d, dt, eps in LN_CASES:
        x, scale, bias = ln_inputs(rows, d, dt, gen)
        got = layer_norm(x, scale, bias, eps)
        torch.cuda.synchronize()
        want = layer_norm_ref(x, scale, bias, eps)
        check(got.shape == want.shape and got.dtype == want.dtype, f"LN {rows}x{d} shape/dtype")
        max_abs, ok, tol = ln_error(got, want)
        ms = _median_ms(lambda: layer_norm(x, scale, bias, eps))
        plain_ms = _median_ms(lambda: layer_norm_ref(x, scale, bias, eps))
        sc, bi = scale.to(dt), bias.to(dt)
        library_ms = _median_ms(lambda: F.layer_norm(x, (d,), sc, bi, eps))
        # x read once and y written once (2 passes), plus the f32 scale and
        # bias; about 9 f32 operations per element (two sums, centre,
        # square, scale, shift)
        bound_ms, bound_by = bound(2 * x.numel() * x.element_size() + 8 * d, 9 * x.numel(), torch.float32)
        log(
            f"[layer_norm] {rows}x{d} {str(dt).split('.')[-1]} eps={eps:g}: max_abs_err={max_abs:.3e} "
            f"{tol} {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.layer_norm {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        )
        check(ok, f"layer_norm {rows}x{d} {dt} disagrees with its plain version")
        rows_out.append(dict(shape=(rows, d), max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))

    fused_out = []
    for site, rows, h_rows, d, dt, eps, keep in ADD_LN_CASES:
        x, scale, bias = ln_inputs(rows, d, dt, gen)
        x = x.reshape(rows // h_rows, h_rows, d)  # h: one (h_rows, d) table for each group of rows
        h = (torch.randn(h_rows, d, generator=gen, device=DEV) * 3.0 + 1.0).to(dt)
        got = add_layer_norm(x, h, scale, bias, eps, keep_sum=keep)
        torch.cuda.synchronize()
        s_got, y = got if keep else (None, got)
        s_want, y_want = add_layer_norm_ref(x, h, scale, bias, eps, keep_sum=True)
        max_abs, ok, tol = ln_error(y, y_want)
        route = layer_norm(s_want, scale, bias, eps)  # today's route: the add, then the plain entry
        same_as_route = bool(torch.equal(y, route))
        sum_ok = s_got is None or bool(torch.equal(s_got, s_want))
        ms = _median_ms(lambda: add_layer_norm(x, h, scale, bias, eps, keep_sum=keep))
        plain_ms = _median_ms(lambda: add_layer_norm_ref(x, h, scale, bias, eps, keep_sum=keep))
        route_ms = _median_ms(lambda: layer_norm(x + h, scale, bias, eps))
        sc, bi = scale.to(dt), bias.to(dt)
        library_ms = _median_ms(lambda: F.layer_norm(x + h, (d,), sc, bi, eps))
        # x and h read once, y (and s, when kept) written once: 3 or 4
        # passes (h's table once); the add and ~9 f32 operations per element
        es = x.element_size()
        n_bytes = (x.numel() * (3 if keep else 2) + h.numel()) * es + 8 * d
        bound_ms, bound_by = bound(n_bytes, 10 * x.numel(), torch.float32)
        log(
            f"[add_layer_norm] {site}: {rows}x{d} (h {h_rows} rows) {str(dt).split('.')[-1]} eps={eps:g} "
            f"keep_sum={keep}: y max_abs_err={max_abs:.3e} {tol} {'ok' if ok else 'FAIL'}, "
            f"s bit-equal to x + h {sum_ok}, y bit-equal to x + h then K1 {same_as_route}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, x + h then K1 {route_ms:.4f} ms, x + h then F.layer_norm {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {3 + keep if h_rows == rows else 2 + keep} passes)"
        )
        check(ok and sum_ok and same_as_route, f"add_layer_norm {site} disagrees with its plain version")
        # No single PyTorch call adds and normalises: library_ms is null,
        # and the two-call forms stand beside the kernel instead.
        fused_out.append(dict(shape=(rows, d), site=site, keep_sum=keep, max_abs_err=max_abs, ms=ms,
                              plain_ms=plain_ms, route_ms=route_ms, add_library_ms=library_ms, library_ms=None,
                              bound_ms=bound_ms, bound_by=bound_by))

    floor = min(floor, launch_floor_ms())  # timed again at the end: the same moment as the cases
    small = [r for r in rows_out if r["shape"] in LN_ROBOT_SHAPES]
    log(f"[layer_norm] launch floor (an empty kernel, event to event, median of 50): {floor:.4f} ms; at the robot "
        f"path's B=1 shapes " + "; ".join(
            f"{r['shape']} K1 {r['ms']:.4f} ms = {r['ms'] / floor:.2f}x the floor, F.layer_norm {r['library_ms']:.4f} "
            f"= {r['library_ms'] / floor:.2f}x, bound {r['bound_ms'] * 1e3:.2f} us" for r in small))
    check(len(small) == len(LN_ROBOT_SHAPES), "phase 25's LayerNorm shapes are not all timed")
    # The host's side of a call at the B=1 act's ViT-g shape, in its three forms.
    x, scale, bias = ln_inputs(257, 1408, torch.bfloat16, gen)
    h = torch.randn_like(x)
    sc, bi = scale.to(x.dtype), bias.to(x.dtype)
    host = dict(k1=host_us(lambda: layer_norm(x, scale, bias, 1e-6)),
                fused=host_us(lambda: add_layer_norm(x, h, scale, bias, 1e-6, keep_sum=True)),
                route=host_us(lambda: layer_norm(x + h, scale, bias, 1e-6)),
                library=host_us(lambda: F.layer_norm(x + h, (1408,), sc, bi, 1e-6)))
    log(f"[layer_norm] host cost per call at (257, 1408) bf16 (wall per call over {HOST_CALLS} back-to-back calls): "
        f"K1 {host['k1']:.2f} us, add_layer_norm {host['fused']:.2f} us, x + h then K1 {host['route']:.2f} us, "
        f"x + h then F.layer_norm {host['library']:.2f} us")
    plain = {**rows_out[0], "launch_floor_ms": floor, "host_us": host["k1"]}  # the ViT-g serving shape
    fused = {**fused_out[0], "host_us": host["fused"]}
    return plain, fused


def vit_unfused(vit, images: torch.Tensor) -> torch.Tensor:
    """``ViTEncoder.forward`` written out as it was before the fused
    entry: every add a PyTorch add, every norm the plain entry of K1."""
    c, conv = vit.cfg, vit.patch_embed
    dt = torch.promote_types(images.dtype, conv.weight.dtype)
    x = F.conv2d(images.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt), stride=c.patch_size)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([vit.class_embedding.to(x.dtype).expand(x.shape[0], 1, c.width), x], dim=1)
    x = x + vit.position_embedding[None].to(x.dtype)
    for i in range(c.depth):
        blk = getattr(vit, f"block{i}")
        x = x + blk.attn(blk.ln1(x))
        x = x + blk.mlp(blk.ln2(x))
    return vit.post_ln(x)


def qformer_unfused(qf, queries: torch.Tensor, image_embeds: torch.Tensor) -> torch.Tensor:
    """The Q-Former's query branch, each post-norm site an add then K1."""
    x = qf.embed_ln(queries)
    for i in range(qf.cfg.layers):
        layer = getattr(qf, f"layer{i}")
        x = layer.self_ln(layer.self_attn(x) + x)
        if layer.has_cross:
            x = layer.cross_ln(layer.cross_attn(x, kv=image_embeds) + x)
        h = layer.ffn_query_fc2(F.gelu(layer.ffn_query_fc1(x)))
        x = layer.ffn_query_ln(h + x)
    return x


def clip_layers_unfused(enc, x: torch.Tensor, mask=None) -> torch.Tensor:
    for i in range(enc.cfg.layers):
        layer = getattr(enc, f"layer{i}")
        x = x + layer.attn(layer.ln1(x), mask)
        x = x + layer.fc2(quick_gelu(layer.fc1(layer.ln2(x))))
    return x


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(-1, keepdim=True)) + 1e-6)


def owl_detect_unfused(m, images: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor):
    """``OwlViTDetectionModule.forward`` with every add before a norm a
    PyTorch add and every norm the plain entry of K1."""
    v, t = m.vision, m.text
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    x = ((images - mean) / std).to(m.cfg.compute_dtype)
    w = v.patch_embed.weight
    dt = torch.promote_types(x.dtype, w.dtype)
    x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), w.to(dt), stride=v.cfg.patch_size).flatten(2).transpose(1, 2)
    x = torch.cat([v.class_embedding.to(x.dtype).expand(x.shape[0], 1, v.cfg.hidden), x], dim=1)
    x = v.pre_ln(x + v.position_embed[None].to(x.dtype))
    h = m.post_ln(clip_layers_unfused(v, x))
    feats = m.merge_ln(h[:, 1:] * h[:, :1])
    e = t.token_embed(ids)
    e = t.final_ln(clip_layers_unfused(t, e + t.position_embed[None, : ids.shape[1]].to(e.dtype), mask))
    txt = l2_normalize(m.text_projection(e[torch.arange(e.shape[0], device=e.device), ids.argmax(-1)]))
    boxes = torch.sigmoid(m.box_head(feats) + box_bias(v.cfg.grid, feats.device)[None])
    img_cls = l2_normalize(m.class_dense(feats))
    img_cls, txt = (u.to(torch.promote_types(img_cls.dtype, txt.dtype)) for u in (img_cls, txt))
    logits = torch.einsum("bpd,td->bpt", img_cls, txt)
    return boxes, (logits + m.logit_shift(feats)) * (F.elu(m.logit_scale(feats)) + 1.0)


@torch.inference_mode()
def phase_fused_route(engine: PerceptionEngine, det, rgb: torch.Tensor) -> None:
    """The models' fused route against the unfused composition above, at
    full width on the card, bit for bit: ViT-g at B=8 and B=1, the
    Q-Former's query branch on each, and one OWL-ViT detect at B=8 over
    the 80 COCO prompts; K1's launches and the fused ones counted."""
    itm = engine.itm.module
    for b in (BATCH_LANES, 1):
        images = ((engine.itm.preprocess(rgb[:b]) - torch.tensor(BLIP_MEAN, device=DEV))
                  / torch.tensor(BLIP_STD, device=DEV)).to(itm.cfg.compute_dtype)
        reset_counters()
        embeds = itm.vision(images)
        queries = itm.query_tokens.to(itm.cfg.compute_dtype).repeat(b, 1, 1)
        out = itm.qformer(queries, image_embeds=embeds, is_query=True)
        counts = (counted("K1.launches"), counted("K1.fused_launches"))
        want_embeds = vit_unfused(itm.vision, images)
        want_out = qformer_unfused(itm.qformer, queries, embeds)
        log(f"[fused] B={b}: ViT-g (bf16 {tuple(embeds.shape)}) and the Q-Former's query branch through the fused "
            f"route against the unfused composition: ViT-g bit-equal {bool(torch.equal(embeds, want_embeds))}, "
            f"Q-Former bit-equal {bool(torch.equal(out, want_out))}; K1 {counts[0]} (expect {LAUNCHES_IMAGE}), "
            f"fused {counts[1]} (expect {FUSED_IMAGE})")
        check(torch.equal(embeds, want_embeds) and torch.equal(out, want_out),
              f"B={b}: the fused route differs from the unfused composition")
        check(counts == (LAUNCHES_IMAGE, FUSED_IMAGE), f"B={b}: ITM K1 launches {counts}")
    m = det.module
    images = det.preprocess(rgb)
    ids, mask = (torch.as_tensor(a, device=DEV) for a in encode_queries(COCO_CLASSES))
    reset_counters()
    boxes, logits = m(images, ids, mask)
    counts = (counted("K1.launches"), counted("K1.fused_launches"))
    want_boxes, want_logits = owl_detect_unfused(m, images, ids, mask)
    same = bool(torch.equal(boxes, want_boxes) and torch.equal(logits, want_logits))
    log(f"[fused] OWL-ViT detect at B={rgb.shape[0]} over the {len(COCO_CLASSES)} COCO prompts through the fused "
        f"route against the unfused composition: boxes and logits bit-equal {same}; K1 {counts[0]} (expect "
        f"{LAUNCHES_DETECT}), fused {counts[1]} (expect {FUSED_DETECT})")
    check(same, "OWL-ViT detect: the fused route differs from the unfused composition")
    check(counts == (LAUNCHES_DETECT, FUSED_DETECT), f"OWL-ViT detect K1 launches {counts}")


# --- phase 3 -----------------------------------------------------------------
def attention_inputs(shape, dtype, gen, layout: str = ""):
    """Seeded q, k, v on the card. ``layout``: "" contiguous (B, H, L, D);
    "kt" K stored as (B, H, D, L); "qkv" views of one fused (B, L, 3HD)
    projection, as the ViT passes them."""
    b, h, l, d = shape
    if layout == "qkv":
        return qkv_views(torch.randn(b, l, 3 * h * d, generator=gen, device=DEV).to(dtype), h)
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device=DEV).to(dtype) for _ in range(3))
    if layout == "kt":
        k = k.transpose(-1, -2).contiguous().transpose(-1, -2)
    return q, k, v


def attention_bound(shape, dtype) -> tuple[float, str]:
    """q, k and v read once and o written once; 2 L^2 D operations for each
    of the two products, per head."""
    b, h, l, d = shape
    return bound(4 * b * h * l * d * torch.finfo(dtype).bits // 8, 4 * b * h * l * l * d, dtype)


def phase_attention() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = [("max/probs, qkv views (the main path)", ATTN_SHAPE, torch.bfloat16, ATTN_VARIANTS[0][2], "qkv"),
             ("max/probs, qkv views (the spin's 12 views)", ATTN_SPIN_SHAPE, torch.bfloat16, ATTN_VARIANTS[0][2],
              "qkv")]
    cases += [(f"max/probs, qkv views (the decision step at B={shape[0]})", shape, torch.bfloat16,
               ATTN_VARIANTS[0][2], "qkv") for shape in ATTN_STEP_SHAPES]
    cases += [(name, ATTN_SHAPE, torch.bfloat16, kw, "kt" if kt else "") for name, _, kw, kt in ATTN_VARIANTS]
    for shape, dt in ATTN_RAGGED:
        variants = ATTN_VARIANTS[:1] if dt == torch.bfloat16 else (ATTN_VARIANTS[0], ATTN_VARIANTS[3])
        cases += [(name, shape, dt, kw, "kt" if kt else "") for name, _, kw, kt in variants]
    rows_out = []
    for name, shape, dt, kw, layout in cases:
        q, k, v = attention_inputs(shape, dt, gen, layout)
        got = attention(q, k, v, **kw)
        torch.cuda.synchronize()
        body = attention_plan(q, k, v, got).describe()
        want = attention_ref(q, k, v, **kw)
        check(got.shape == want.shape and got.dtype == want.dtype, f"K3 {name} {shape} shape/dtype")
        err = (got.float() - want.float()).abs()
        ratio = float((err / attention_tolerance(want, kw.get("round_logits", False))).max())
        max_abs = float(err.max())
        ms = _median_ms(lambda: attention(q, k, v, **kw))
        plain_ms = _median_ms(lambda: attention_ref(q, k, v, **kw))
        library_ms = _median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = attention_bound(shape, dt)
        tol = "2e-5" if dt == torch.float32 else "2e-2" if kw.get("round_logits") else "2 bf16 ulps of plain, floor 4e-3"
        parent = PARENT_K3_MS.get((name, shape))
        log(
            f"[attention] {shape} {str(dt).split('.')[-1]} {name} ({body}): max_abs_err={max_abs:.3e}, "
            f"{ratio:.2f} of the tolerance ({tol}) "
            f"{'ok' if ratio <= 1 else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            + (f", the parent's kernel {parent:.4f} ms ({PARENT_CARD})" if parent else "")
        )
        check(ratio <= 1.0, f"attention {name} {shape} {dt} disagrees with its plain version")
        rows_out.append(dict(name=name, shape=shape, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
        del q, k, v, got, want, err
    return rows_out[0]  # the main path's layout and variant at the ViT-g shape stands for the kernel


# --- phase 4 -----------------------------------------------------------------
def phase_tiny_model() -> None:
    cfg = dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    itm_cpu = BLIP2ITM.init_random(cfg, seed=0, device="cpu")
    itm_gpu = BLIP2ITM(cfg, copy.deepcopy(itm_cpu.module).to(DEV))
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (3, 56, 56, 3)).astype(np.float32))
    tok = WordPieceTokenizer(toy_vocab(), max_len=16)
    ids, mask = tok.encode_batch(["a red chair", "a bed"])
    want = itm_cpu.cosine(imgs, ids, mask)
    ln0, k30 = counted("K1.launches"), counted("K3.launches")
    got = itm_gpu.cosine(imgs.to(DEV), ids.to(DEV), mask.to(DEV)).cpu()
    err = float((got - want).abs().max())
    log(
        f"[tiny] cosines gpu vs cpu: max_abs_err={err:.3e} (tol {TINY_COS_ATOL}), "
        f"K1 {counted("K1.launches") - ln0}, K3 {counted("K3.launches") - k30} launches"
    )
    check(err <= TINY_COS_ATOL, "tiny BLIP2-ITM cosines differ between card and CPU")
    check(counted("K1.launches") > ln0, "tiny model on the card did not launch K1")
    check(counted("K3.launches") - k30 == cfg.vit.depth, "tiny model on the card: one K3 launch per ViT block")


# --- phase 5 -----------------------------------------------------------------
def spin_views(n: int, width: int = 640, height: int = 480, seed: int = 0) -> list[dict]:
    env = FakeObjectNavEnv(two_room_plan(seed=seed), EnvConfig(width=width, height=height))
    views = [env.reset()]
    views += [env.step(TURN_LEFT) for _ in range(n - 1)]
    return views


def view_inputs(views, cfg: VLFMConfig, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(camera-to-episodic transform (1, 4, 4), normalized depth (1, H, W))
    of each view: one lane of the maps' batch-first API."""
    out = []
    for o in views:
        xyz = torch.tensor([o["robot_xy"][0], o["robot_xy"][1], cfg.camera.camera_height],
                           dtype=torch.float32, device=device)
        tf = xyz_yaw_to_tf_matrix(xyz, torch.tensor(o["heading"], dtype=torch.float32, device=device))
        out.append((tf[None], torch.from_numpy(o["depth"].astype(np.float32)).to(device)[None]))
    return out


def spin_obstacles(inputs, spec: GridSpec2D, cfg: VLFMConfig, device) -> OM.ObstacleMapState:
    """The obstacle-map half of the spin: one update per view."""
    state = OM.create(spec, cfg.max_frontiers, batch=inputs[0][0].shape[0], device=device)
    for steps, (tf, depth) in enumerate(inputs):
        state = update_obstacles(state, spec, cfg, depth, tf, steps)
    return state


def spin_observations(lane_views, cfg: VLFMConfig) -> list[ITM.Observation]:
    """Per view, the B lanes' observations on the card, one copy each (the
    episode driver's packing)."""
    return [step_inputs([views[v] for views in lane_views], cfg, DEV)[0] for v in range(len(lane_views[0]))]


def spin_steps(observations, cosines: torch.Tensor, spec: GridSpec2D, cfg: VLFMConfig):
    """The spin through the policy step (greedy controller, no detections,
    keys ``fold_in(PRNGKey(lane), view)``), its last view the first EXPLORE
    step: that step decides over the maps of every view, from a fresh
    choice history. ``cosines`` is (B, views, C). Returns (the last step's
    info, the state)."""
    b = observations[0].depth.shape[0]
    h, w = observations[0].depth.shape[1:]
    scfg = dataclasses.replace(cfg, num_init_turns=len(observations) - 1)
    state = ITM.create_state(spec, scfg, batch=b, device=DEV)
    k = cfg.max_detections_per_frame
    masks = torch.zeros((b, k, h, w), dtype=torch.bool, device=DEV)
    valid = torch.zeros((b, k), dtype=torch.bool, device=DEV)
    lanes = threefry.PRNGKey(torch.arange(b, device=DEV))
    cosines = cosines.to(DEV)
    for v, obs in enumerate(observations):
        _, info, state = ITM.step(state, obs, cosines[:, v], masks, valid, threefry.fold_in(lanes, v),
                                  pointnav="greedy", spec=spec, cfg=scfg)
    return info, state


def without_host_sync(fn):
    """Run ``fn`` with every host synchronisation an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_tiny_obstacle_map() -> None:
    t = TINY_MAP
    cfg = dataclasses.replace(VLFMConfig(), map_size=t["map_size"], map_pad=t["map_pad"],
                              camera=dataclasses.replace(VLFMConfig().camera, width=t["width"], height=t["height"]))
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    views = spin_views(t["views"], t["width"], t["height"])
    want = spin_obstacles(view_inputs(views, cfg, "cpu"), spec, cfg, "cpu")
    got = spin_obstacles(view_inputs(views, cfg, DEV), spec, cfg, DEV)
    torch.cuda.synchronize()
    cells = t["views"] * 224 * 224  # the fog-of-war windows the spin updated
    flips = {n: int((getattr(got, n).cpu() != getattr(want, n)).sum()) for n in ("obstacles", "navigable", "explored")}
    valid_eq = torch.equal(got.frontiers_valid.cpu(), want.frontiers_valid)
    fr_err = float((got.frontiers_xy.cpu() - want.frontiers_xy).abs().max())
    log(
        f"[tiny-map] {t['map_size']}+2x{t['map_pad']} px map, {t['views']} views at {t['width']}x{t['height']}: "
        f"card vs CPU flips {flips} (tol {MAP_FLIPS} of {cells} cells), {int(want.frontiers_valid.sum())} "
        f"frontiers, validity equal {valid_eq}, max position error {fr_err:.3e} m (tol {FRONTIER_ATOL_M})"
    )
    check(all(f <= MAP_FLIPS * cells for f in flips.values()), "tiny obstacle map differs between card and CPU")
    check(valid_eq and fr_err <= FRONTIER_ATOL_M, "tiny obstacle map frontiers differ between card and CPU")
    check(bool(want.frontiers_valid.any()), "tiny obstacle map found no frontier")


# --- phase 5b ----------------------------------------------------------------
def sweep_case(lanes: int, size: int, gen: np.random.Generator):
    """A flood and a labelling input like the obstacle map's at ``size``: an
    explored disc of 120 px with scattered walls around the agent, seeded by
    the kept region of the last step (a disc of 100 px) and the agent, and
    the coarse (4x) unexplored mask around it, one component, which the
    labelling's 48 sweeps do not cross."""
    yy, xx = np.mgrid[:size, :size]
    masks, seeds, coarse = [], [], []
    for _ in range(lanes):
        cy, cx = gen.integers(size // 3, 2 * size // 3, 2)
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        explored = (d2 < 120 ** 2) & (gen.random((size, size)) < 0.9)
        masks.append(explored)
        seeds.append(explored & (d2 < 100 ** 2))
        coarse.append(~(explored | (d2 < 130 ** 2)).reshape(size // 4, 4, size // 4, 4).all(axis=(1, 3)))
    return (torch.from_numpy(np.stack(masks)).to(DEV), torch.from_numpy(np.stack(seeds)).to(DEV),
            torch.from_numpy(np.stack(coarse)).to(DEV))


def cluster_barrier_ms(lanes: int) -> float:
    """The card's cluster barrier: ``lanes`` clusters of the sweep kernels'
    shape (8 CTAs of 1024 threads) that only wait on it (``csrc/sweeps.cu``,
    ``vlfm_cluster_sync``), timed at 1,000 and 5,000 barriers, over the
    4,000 between them. The floor of one sweep, which does that and more."""
    from vlfm_tpu_torch.kernels.build import load_library

    lib = load_library()

    def run(iters):
        err = lib.vlfm_cluster_sync(lanes, iters, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the cluster barrier kernel failed: cudaError {err}")

    return (_median_ms(lambda: run(5000), reps=20) - _median_ms(lambda: run(1000), reps=20)) / 4000


def corridor_sweep_ms() -> float:
    """One sweep of the flood kernel with next to no work: a (1, 8, 31)
    flood along a corridor that folds three times, one grid row a CTA, less
    a flood that stops at its first sweep, over the sweeps between them (the
    barrier, the block-wide OR, the flag's store and read through
    distributed shared memory, the loop). The kernel's own cost, not a
    bound."""
    snake = torch.zeros((1, 8, 31), dtype=torch.bool)
    snake[0, ::2] = True
    snake[0, 1, 30] = snake[0, 3, 0] = snake[0, 5, 30] = True
    seed = torch.zeros_like(snake)
    seed[0, 0, 0] = True
    m, s, none = snake.to(DEV), seed.to(DEV), torch.zeros_like(snake).to(DEV)
    reset_counters()
    check(torch.equal(FL.flood_from_seed(m, s).cpu(), snake), "the corridor did not flood whole")
    n = counted("map.sweeps")
    long_ms = _median_ms(lambda: FL.flood_from_seed(m, s))
    short_ms = _median_ms(lambda: FL.flood_from_seed(m, none))
    log(f"[sweeps] corridor: {n} sweeps {long_ms:.4f} ms, one sweep {short_ms:.4f} ms")
    return (long_ms - short_ms) / (n - 1)


def phase_sweeps() -> tuple[dict, dict]:
    """The flood and labelling kernels (csrc/sweeps.cu) at the obstacle
    map's 1344 x 1344 and its coarse 336 x 336 grid, 1 and 8 lanes: bits
    against the plain loops on the card, device ms (events) and wall ms
    against the plain loops' wall ms, the sweeps the batch ran, and the
    bound: the larger of the bytes once over HBM's rate and the sweeps times
    the card's cluster barrier at as many clusters as lanes."""
    gen = np.random.default_rng(11)
    corridor = corridor_sweep_ms()
    log(f"[sweeps] the flood kernel's sweep with next to no work (its own cost) {corridor * 1e3:.2f} us")
    out = {}
    for lanes in (1, 8):
        barrier = cluster_barrier_ms(lanes)
        log(f"[sweeps] the cluster barrier alone, {lanes} clusters of 8 x 1024 threads: {barrier * 1e3:.3f} us")
        mask, seed, coarse = sweep_case(lanes, 1344, gen)
        for name, fn, ref, n_bytes in (
                ("flood", lambda: FL.flood_from_seed(mask, seed), lambda: FL.flood_from_seed_ref(mask, seed),
                 3 * mask.numel()),
                ("label", lambda: FL.label_components(coarse, 48), lambda: FL.label_components_ref(coarse, 48),
                 5 * coarse.numel())):
            reset_counters()
            got = fn()
            torch.cuda.synchronize()
            sweeps = counted("map.sweeps")
            check(counted(f"{name}.launches") == 1, f"{name}: one launch a call, counted on the device")
            reset_counters()
            want = ref()
            plain_sweeps = counted("map.sweeps")
            check(torch.equal(got, want), f"{name} kernel differs from the plain loop at {lanes} lanes")
            ms, wall, plain = _median_ms(fn), wall_ms(fn), wall_ms(ref, reps=5, warmup=1)
            # a sweep's cost at this shape: the same call cut at 16 sweeps
            if name == "flood":
                ms16 = _median_ms(lambda: FL.flood_from_seed(mask, seed, max_iters=16))
            else:
                ms16 = _median_ms(lambda: FL.label_components(coarse, 16))
            per_sweep = (ms - ms16) / (sweeps - 16) if sweeps > 16 else float("nan")
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            b_ms, b_by = max((t_bytes, "bytes"), (sweeps * barrier, "sweeps x barrier"))
            shape = tuple((mask if name == "flood" else coarse).shape)
            log(f"[sweeps] {name} {shape}: {sweeps} sweeps (plain loop {plain_sweeps}), kernel {ms:.4f} ms device "
                f"({ms16:.4f} at 16 sweeps, {per_sweep * 1e3:.2f} us a sweep), {wall:.4f} ms wall; plain loop "
                f"{plain:.4f} ms wall; bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms); bits equal")
            out[(name, lanes)] = dict(max_abs_err=0.0, ms=ms, wall_ms=wall, plain_ms=plain, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=None, sweeps=sweeps, plain_sweeps=plain_sweeps,
                                      sweep_us=per_sweep * 1e3, barrier_us=barrier * 1e3,
                                      corridor_sweep_us=corridor * 1e3)
    return out[("flood", 8)], out[("label", 8)]


# --- phase 6 -----------------------------------------------------------------
def phase_main_path(views, engine: PerceptionEngine, spec, cfg) -> dict:
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(DEV)
    observations = spin_observations([views], cfg)
    reset_counters()
    t0 = time.perf_counter()
    engine.text_features(TARGET)
    torch.cuda.synchronize()
    text = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"))
    cosines = engine.score(rgb, TARGET)
    torch.cuda.synchronize()
    image = dict(layer_norm=counted("K1.launches") - text["layer_norm"],
                 attention=counted("K3.launches") - text["attention"])
    info, state = spin_steps(observations, cosines[None], spec, cfg)
    action = int(info.action)
    wall = time.perf_counter() - t0
    launches = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"))
    log(
        f"[main] K1 launches: encode_texts {text['layer_norm']} (expect {LAUNCHES_TEXT}), "
        f"cosine_cached_text {image['layer_norm']} (expect {LAUNCHES_IMAGE}); K3 launches: encode_texts "
        f"{text['attention']} (expect {ATTN_LAUNCHES_TEXT}), cosine_cached_text {image['attention']} "
        f"(expect {ATTN_LAUNCHES_IMAGE})"
    )
    check(text["layer_norm"] == LAUNCHES_TEXT, "encode_texts K1 launch count")
    launches = with_fused(launches, "main", FUSED_TEXT + FUSED_IMAGE)
    check(image["layer_norm"] == LAUNCHES_IMAGE, "cosine_cached_text K1 launch count")
    check(text["attention"] == ATTN_LAUNCHES_TEXT, "encode_texts K3 launch count")
    check(image["attention"] == ATTN_LAUNCHES_IMAGE, "cosine_cached_text K3 launch count")

    c = cosines.float().cpu()
    log(f"[main] cosines {tuple(c.shape)}: {[round(v, 5) for v in c[:, 0].tolist()]}")
    check(c.shape == (len(views), cfg.value_channels), "cosine shape")
    check(bool(torch.isfinite(c).all()), "cosines finite")
    obstacle, value = state.obstacle, state.value
    check(bool(torch.isfinite(value.values).all() and torch.isfinite(value.conf).all()), "value map finite")
    valid = obstacle.frontiers_valid.cpu()
    fxy = obstacle.frontiers_xy.cpu()[valid]
    log(
        f"[main] obstacle map: {int(obstacle.obstacles.sum())} obstacle cells, {int(obstacle.explored.sum())} "
        f"explored, {int(valid.sum())} frontiers {[tuple(round(v, 2) for v in xy) for xy in fxy.tolist()]}, "
        f"overflow {bool(obstacle.frontier_overflow)}"
    )
    check(bool(valid.any()), "the obstacle map has no valid frontier")
    log(
        f"[main] step {int(state.steps)} (mode {int(info.mode)}) chose frontier "
        f"{[round(v, 3) for v in info.goal[0].tolist()]}, value {float(info.best_value):.5f}, rho "
        f"{float(info.rho):.3f} theta {float(info.theta):.3f}, action {action}; wall {wall:.2f} s incl. first calls"
    )
    check(int(info.mode) == ITM.MODE_EXPLORE, "the spin's last view is not an EXPLORE step")
    check(action in (ITM.MOVE_FORWARD, ITM.TURN_LEFT, ITM.TURN_RIGHT), "the greedy controller did not steer")
    check(int(info.num_frontiers) > 0, "the decision found no frontier")
    check(all(bool(torch.isfinite(t).all()) for t in (info.goal, info.best_value, info.rho, info.theta)),
          "decision finite")
    wvals = VM.waypoint_values(value, spec, obstacle.frontiers_xy, obstacle.frontiers_valid,
                               radius_px=int(0.5 * spec.pixels_per_meter))
    check(bool(torch.isfinite(wvals[valid.to(DEV)]).all()), "frontier values finite")
    return launches


# --- phase 7 -----------------------------------------------------------------
def phase_value_map_check(views, spec, cfg) -> None:
    cos = torch.full((len(views), cfg.value_channels), 0.1)
    cos[HIGH_VIEW] = 0.9
    info, _ = spin_steps(spin_observations([views], cfg), cos[None], spec, cfg)
    robot = views[-1]["robot_xy"]
    fx, fy = info.goal[0].tolist()
    off = math.remainder(math.atan2(fy - robot[1], fx - robot[0]) - views[HIGH_VIEW]["heading"], 2 * math.pi)
    log(
        f"[value-map] injected high cosine at view {HIGH_VIEW}: chose frontier ({fx:.2f}, {fy:.2f}) at "
        f"{math.degrees(off):.1f} deg from that view's heading, value {float(info.best_value):.4f}"
    )
    check(abs(off) <= cfg.camera.hfov / 2, "the chosen frontier is not in the high-value view's field of view")


# --- phase 8 -----------------------------------------------------------------
def itm_batch_ms(views, engine: PerceptionEngine, batch: int = 32) -> float:
    """Median wall time of one full-width ITM scoring call on ``batch``
    preprocessed spin frames, each call ending in a device synchronise."""
    rgb = np.stack([views[i % len(views)]["rgb"] for i in range(batch)])
    itm = engine.itm
    imgs = itm.preprocess(torch.from_numpy(rgb).to(itm.device))
    feats = engine.text_features(TARGET)
    return wall_ms(lambda: itm.cosine_cached_text(imgs, feats), reps=10, warmup=3)


def spin_step_fns(views, engine: PerceptionEngine, spec, cfg):
    """The 12-view spin step whole (ITM scoring, then a policy step per
    view, the last one deciding) and its obstacle-map part alone, on frames
    already on the card."""
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(DEV)
    observations = spin_observations([views], cfg)
    inputs = view_inputs(views, cfg, DEV)

    def step():
        return spin_steps(observations, engine.score(rgb, TARGET)[None], spec, cfg)

    return step, lambda: spin_obstacles(inputs, spec, cfg, DEV)


def phase_timing(views, engine: PerceptionEngine, spec, cfg, smi: str) -> None:
    ms = itm_batch_ms(views, engine)
    log(
        f"[itm] full-width BLIP2-ITM B=32: {ms:.2f} ms/batch median of 10 "
        f"({32 / ms * 1e3:.1f} images/s) on {smi}"
    )
    step, obstacles = spin_step_fns(views, engine, spec, cfg)
    step_ms = wall_ms(step, reps=5, warmup=1)
    om_ms = wall_ms(obstacles, reps=5, warmup=1)
    log(
        f"[step] 12-view spin step: {step_ms:.2f} ms whole, of which the 12 obstacle-map updates "
        f"{om_ms:.2f} ms (wall, median of 5) on {smi}"
    )


# --- phase 9 -----------------------------------------------------------------
def chain_inputs(shape, ch, cout, dtype, gen):
    """x and lecun-scaled chain weights in the JAX layouts, biases f32."""
    cin = shape[-1]

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=DEV) * scale

    x = rnd(*shape).to(dtype)
    w = (rnd(cin, ch, scale=cin**-0.5).to(dtype), 0.1 * rnd(ch), rnd(3, 3, ch, scale=1 / 3).to(dtype),
         0.1 * rnd(ch), rnd(ch, cout, scale=ch**-0.5).to(dtype), 0.1 * rnd(cout))
    return x, w


def phase_mbconv_chain() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows_out = []
    for shape, ch, cout, res, dt in CHAIN_CASES:
        x, w = chain_inputs(shape, ch, cout, dt, gen)
        got = mbconv_chain(x, *w, residual=res, final_gelu=res)
        torch.cuda.synchronize()
        want = mbconv_chain_ref(x, *w, residual=res, final_gelu=res)
        check(got.shape == want.shape and got.dtype == want.dtype, f"K2 {shape} shape/dtype")
        err = (got.float() - want.float()).abs()
        ratio = float((err / chain_tolerance(want)).max())
        max_abs = float(err.max())
        ms = _median_ms(lambda: mbconv_chain(x, *w, residual=res, final_gelu=res))
        plain_ms = _median_ms(lambda: mbconv_chain_ref(x, *w, residual=res, final_gelu=res))
        # x read and y written once (the weights are small); the two 1x1
        # products and the 3x3 depthwise taps, 2 operations per multiply-add
        pixels = x.numel() // x.shape[-1]
        n_bytes = (x.numel() + pixels * cout) * x.element_size() + sum(t.numel() * t.element_size() for t in w)
        bound_ms, bound_by = bound(n_bytes, 2 * pixels * (shape[-1] * ch + 9 * ch + ch * cout), dt)
        tol = "1e-5 relative" if dt == torch.float32 else "2 bf16 ulps of plain, floor 4e-3"
        parent = PARENT_K2_MS.get(shape)
        log(
            f"[mbconv_chain] {shape}->{ch}->{cout} {str(dt).split('.')[-1]} res={res} "
            f"({chain_plan(x, *w[:5], got).body}): max_abs_err={max_abs:.3e}, {ratio:.2f} of the "
            f"tolerance ({tol}), {float((err > 0).float().mean()):.2e} of elements differ "
            f"{'ok' if ratio <= 1 else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes the chain"
            + (f"; the parent's kernel {parent:.4f} ms ({PARENT_CARD})" if parent else "")
        )
        check(ratio <= 1.0, f"mbconv_chain {shape} {dt} disagrees with its plain version")
        rows_out.append(dict(shape=shape, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        del x, w, got, want, err
    return rows_out[0]  # stage 0 at B=8 stands for the kernel


# --- phase 10 ----------------------------------------------------------------
def encode_queries(names):
    """Prompt ids for OWL-ViT: the toy WordPiece vocabulary, 8 tokens."""
    return WordPieceTokenizer(toy_vocab(), max_len=8).encode_batch(list(names))


def make_pipeline(det, sam, cfg: VLFMConfig, capacity, non_coco_threshold=None) -> DetectionPipeline:
    k = cfg.max_detections_per_frame
    coco = CocoDetector(det, encode_queries, conf_threshold=cfg.coco_threshold, max_detections=k)
    return DetectionPipeline(
        det, sam, encode_queries, coco_detector=coco, coco_threshold=cfg.coco_threshold,
        non_coco_threshold=cfg.non_coco_threshold if non_coco_threshold is None else non_coco_threshold,
        max_detections=k, sam_frame_capacity=capacity,
    )


def phase_tiny_pipeline() -> None:
    cfg = VLFMConfig()
    det_cpu = OwlViTDetector.init_random(OwlViTDetConfig.tiny(), seed=0, device="cpu")
    sam_cpu = SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device="cpu")
    det_gpu = OwlViTDetector(det_cpu.cfg, copy.deepcopy(det_cpu.module).to(DEV))
    sam_gpu = SAM(sam_cpu.cfg, copy.deepcopy(sam_cpu.module).to(DEV))
    rgb = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (5, 48, 64, 3), dtype=np.uint8))
    for target, thr in ((COCO_TARGET, None), (OPEN_TARGET, 0.0)):
        want = make_pipeline(det_cpu, sam_cpu, cfg, 2, thr)(rgb, target)
        ln0, k20 = counted("K1.launches"), counted("K2.launches")
        got = make_pipeline(det_gpu, sam_gpu, cfg, 2, thr)(rgb.to(DEV), target)
        torch.cuda.synchronize()
        (gm, gv, (gx, gs, gc)), (wm, wv, (wx, ws, wc)) = got, want
        box_err = max(float((gx.cpu() - wx).abs().max()), float((gs.cpu() - ws).abs().max()))
        flips = float((gm.cpu() != wm).float().mean())
        log(
            f"[tiny-det] {target}: card vs CPU boxes/scores max_abs_err={box_err:.3e} (tol {TINY_BOX_ATOL}), "
            f"valid equal {bool(torch.equal(gv.cpu(), wv))}, cls equal {bool(torch.equal(gc.cpu(), wc))}, "
            f"{int(wv.sum())} detections, mask flips {flips:.2e} (tol {TINY_MASK_FLIPS}); "
            f"K1 {counted("K1.launches") - ln0}, K2 {counted("K2.launches") - k20} launches"
        )
        check(box_err <= TINY_BOX_ATOL, f"tiny pipeline boxes differ between card and CPU ({target})")
        check(torch.equal(gv.cpu(), wv) and torch.equal(gc.cpu(), wc), f"tiny pipeline valid/cls ({target})")
        check(flips <= TINY_MASK_FLIPS, f"tiny pipeline masks differ between card and CPU ({target})")
        check(counted("K1.launches") > ln0, "tiny pipeline on the card did not launch K1")
        if bool(wv.any()):
            check(counted("K2.launches") > k20, "tiny pipeline on the card did not launch K2")


# --- phase 11 ----------------------------------------------------------------
def build_detection_path():
    """The full-width detection configuration: OWL-ViT base-32 and MobileSAM
    with random bf16 weights (f32 norms), the VLFMConfig thresholds, SAM
    gated at max(2, B // 4) frames, and 8 frames of the spin."""
    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=max(2, DET_BATCH // 4))
    det = OwlViTDetector.init_random(OwlViTDetConfig(compute_dtype=torch.bfloat16), seed=0, device=DEV)
    sam = SAM.init_random(SamConfig.mobile_sam(), seed=0, device=DEV)
    cast_for_serving(det.module)
    cast_for_serving(sam.module)
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in spin_views(DET_BATCH)])).to(DEV)
    return cfg, det, sam, rgb


def check_detections(name, out, b, h, w, k, n_classes=80) -> int:
    """Shapes, finite boxes in [0, 1], masks only on valid slots, and class
    ids below ``n_classes`` (the COCO classes, or a caption's phrases).
    Returns the number of frames with a valid detection."""
    masks, valid, (xyxy, scores, cls) = out
    check(masks.shape == (b, k, h, w) and masks.dtype == torch.bool, f"{name}: mask shape")
    check(valid.shape == (b, k) and xyxy.shape == (b, k, 4), f"{name}: box shape")
    check(bool(torch.isfinite(xyxy).all() and torch.isfinite(scores.float()).all()), f"{name}: finite boxes")
    check(bool(((xyxy >= 0) & (xyxy <= 1)).all()), f"{name}: boxes in [0, 1]")
    check(not bool(masks[~valid].any()), f"{name}: masks only where valid")
    check(bool(((cls >= 0) & (cls < n_classes)).all()), f"{name}: class ids")
    return int(valid.any(dim=1).sum())


def phase_detection_path(cfg, det, sam, rgb) -> dict:
    b, h, w = rgb.shape[:3]
    k, cap = cfg.max_detections_per_frame, cfg.sam_frame_capacity
    per_pass = chain_launches(sam.cfg.tinyvit)
    pipe_coco = make_pipeline(det, sam, cfg, cap)
    pipe_open = make_pipeline(det, sam, cfg, cap, non_coco_threshold=0.0)
    reset_counters()
    t0 = time.perf_counter()
    out_coco = pipe_coco(rgb, COCO_TARGET)
    torch.cuda.synchronize()
    ln_coco, k2_coco = counted("K1.launches"), counted("K2.launches")
    out_open = pipe_open(rgb, OPEN_TARGET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layer_norm=counted("K1.launches"), mbconv_chain=counted("K2.launches"))
    ln_open, k2_open = launches["layer_norm"] - ln_coco, launches["mbconv_chain"] - k2_coco

    frames_coco = check_detections(COCO_TARGET, out_coco, b, h, w, k)
    frames_open = check_detections(OPEN_TARGET, out_open, b, h, w, k)
    passes_coco, passes_open = -(-frames_coco // cap), -(-frames_open // cap)
    log(
        f"[detect] {COCO_TARGET}: {int(out_coco[1].sum())} detections on {frames_coco} of {b} frames, "
        f"{passes_coco} SAM passes; K1 {ln_coco} (expect {2 * LAUNCHES_DETECT}), "
        f"K2 {k2_coco} (expect {per_pass * passes_coco})"
    )
    log(
        f"[detect] {OPEN_TARGET} at threshold 0: {int(out_open[1].sum())} detections on {frames_open} of "
        f"{b} frames, {passes_open} SAM passes; K1 {ln_open} (expect {LAUNCHES_DETECT}), "
        f"K2 {k2_open} (expect {per_pass * passes_open}); wall {wall:.2f} s incl. first calls"
    )
    check(ln_coco == 2 * LAUNCHES_DETECT and ln_open == LAUNCHES_DETECT, "detection path K1 launch count")
    launches = with_fused(launches, "detect", 3 * FUSED_DETECT)
    check(k2_coco == per_pass * passes_coco and k2_open == per_pass * passes_open, "K2 launches per SAM pass")
    check(frames_open == b and passes_open == -(-b // cap), "threshold 0 must put detections on every frame")

    ungated = make_pipeline(det, sam, cfg, None, non_coco_threshold=0.0)(rgb, OPEN_TARGET)
    gm, gv, _ = out_open
    um, uv, _ = ungated
    check(torch.equal(gv, uv), "gated and ungated validity differ")
    flips = float((gm != um)[gv].float().mean())
    log(f"[detect] gated (capacity {cap}) against ungated masks on valid slots: {flips:.2e} of pixels flip "
        f"(tol {GATED_MASK_FLIPS})")
    check(flips <= GATED_MASK_FLIPS, "gated masks differ from ungated masks")
    return launches


# --- phase 12 ----------------------------------------------------------------
def phase_detection_timing(cfg, det, sam, rgb, smi: str) -> None:
    pipe = make_pipeline(det, sam, cfg, cfg.sam_frame_capacity)
    s = sam.cfg.vision.image_size
    sam_imgs = resize_bilinear(rgb.to(torch.float32), s, s)
    out = pipe(rgb, COCO_TARGET)
    boxes = out[2][0]
    ids, mask = pipe._queries(COCO_TARGET)
    coco_ids, coco_mask = pipe.coco_detector._coco_queries()
    imgs = det.preprocess(rgb)
    emb = sam.encode(sam_imgs)
    parts = {
        f"pipeline call ({COCO_TARGET}, both routes, gated SAM)": lambda: pipe(rgb, COCO_TARGET),
        "OWL-ViT detect, 80 COCO prompts": lambda: det.detect(imgs, coco_ids, coco_mask),
        "OWL-ViT detect, 1 prompt": lambda: det.detect(imgs, ids, mask),
        f"SAM encode, {DET_BATCH} frames": lambda: sam.encode(sam_imgs),
        "SAM encode, 2 frames (one gated pass)": lambda: sam.encode(sam_imgs[:2]),
        f"SAM decode, {DET_BATCH} frames x {boxes.shape[1]} boxes": lambda: sam.decode(emb, boxes),
    }
    for name, fn in parts.items():
        ms = wall_ms(fn)
        log(f"[det-time] B={DET_BATCH} {name}: {ms:.2f} ms (wall, median of 10) on {smi}")


# --- phase 13 ----------------------------------------------------------------
def deform_inputs(b, q, nh, dh, levels, npts, vdtype, wdtype, kind, gen):
    """Seeded value, grids and softmaxed weights on the card. ``kind``:
    "uniform" grids spread over [-1.5, 1.5], the worst case for locality;
    "local" grids at each token's centre (Q = S) plus N(0, 1)-pixel offsets
    per level, as the encoder makes them; "boxes" grids from reference
    boxes, as the decoder makes them. FAR_SHARE of them sit at +-1e6."""
    s = sum(h * w for h, w in levels)

    def rnd(*shape):
        return torch.rand(*shape, generator=gen, device=DEV)

    value = torch.randn(b, s, nh * dh, generator=gen, device=DEV).to(vdtype)
    shape = (b, q, nh, len(levels), npts, 2)
    if kind == "boxes":
        boxes = torch.cat([rnd(b, q, 2), 0.02 + 0.5 * rnd(b, q, 2)], -1)[:, :, None, None, None, :]
        offsets = torch.randn(*shape, generator=gen, device=DEV)
        grids = 2 * (boxes[..., :2] + offsets / npts * boxes[..., 2:] * 0.5) - 1
    elif kind == "local":
        check(q == s, "local grids need one query per token")
        centres = [torch.stack(torch.meshgrid((torch.arange(h, device=DEV) + 0.5) / h,
                                              (torch.arange(w, device=DEV) + 0.5) / w, indexing="ij")[::-1], -1)
                   for h, w in levels]  # (H, W, 2) as (x, y)
        refs = torch.cat([c.reshape(-1, 2) for c in centres])[None, :, None, None, None, :]
        pixel = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=DEV)[:, None, :]
        grids = 2 * (refs + torch.randn(*shape, generator=gen, device=DEV) / pixel) - 1
    else:
        grids = (rnd(*shape) * 2 - 1) * 1.5
    grids = torch.where(rnd(*shape) < FAR_SHARE, torch.where(rnd(*shape) < 0.5, -1e6, 1e6), grids).contiguous()
    logits = torch.randn(b, q, nh, len(levels) * npts, generator=gen, device=DEV)
    weights = torch.softmax(logits, -1).reshape(b, q, nh, len(levels), npts).to(wdtype)
    return value, grids, weights


def deform_grid_sample(value, levels, grids, weights):
    """The same function as HF's pure-PyTorch
    ``multi_scale_deformable_attention``: one ``F.grid_sample`` per level
    (bilinear, zeros, align_corners=False), then the weighted sum. Timed
    beside K4 as a yardstick only; the port never calls it. grid_sample
    takes one dtype, so a bf16 value is cast to the grids' f32 first."""
    b, q, nh, nl, npts, _ = grids.shape
    dh = value.shape[-1] // nh
    start, samples = 0, []
    for li, (h, w) in enumerate(levels):
        v = value[:, start:start + h * w].to(grids.dtype).transpose(1, 2).reshape(b * nh, dh, h, w)
        g = grids[:, :, :, li].transpose(1, 2).reshape(b * nh, q, npts, 2)
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
        start += h * w
    wts = weights.transpose(1, 2).reshape(b * nh, 1, q, nl * npts).to(grids.dtype)
    out = (torch.stack(samples, dim=-2).flatten(-2) * wts).sum(-1)  # (B*nh, dh, Q)
    return out.reshape(b, nh, dh, q).permute(0, 3, 1, 2)


def phase_deform_gather() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows_out = []
    for name, b, q, nh, dh, levels, npts, vdt, wdt, kind in DEFORM_CASES:
        value, grids, weights = deform_inputs(b, q, nh, dh, levels, npts, vdt, wdt, kind, gen)
        plan = plan_for(value, grids, weights)
        got = deform_gather(value, levels, grids, weights)
        torch.cuda.synchronize()
        want = deform_gather_ref(value, levels, grids, weights)
        check(got.shape == want.shape == (b, q, nh, dh) and got.dtype == torch.float32, f"K4 {name} shape/dtype")
        max_abs = float((got - want).abs().max())
        tol = deform_gather_tolerance(value, weights)
        gs_err = float((deform_grid_sample(value, levels, grids, weights) - want).abs().max())
        ms = _median_ms(lambda: deform_gather(value, levels, grids, weights))
        plain_ms = _median_ms(lambda: deform_gather_ref(value, levels, grids, weights))
        gs_ms = _median_ms(lambda: deform_grid_sample(value, levels, grids, weights))
        # Each input read once and the f32 output written once. The four
        # taps' weighted sum, the attention weight and the accumulation:
        # 9 operations per channel and ~30 for a sample's position.
        samples = weights.numel()
        n_bytes = sum(t.numel() * t.element_size() for t in (value, grids, weights)) + got.numel() * 4
        bound_ms, bound_by = bound(n_bytes, samples * (9 * dh + 30), torch.float32)
        taps_gb = samples * 4 * dh * value.element_size() / 1e9
        parent = PARENT_K4_MS.get(name)
        log(
            f"[deform_gather] {name}: B={b} Q={q} nh={nh} dh={dh} levels {list(levels)} P={npts} "
            f"value {str(vdt).split('.')[-1]} weights {str(wdt).split('.')[-1]} ({plan.describe()}): "
            f"max_abs_err={max_abs:.3e} (tol {tol:.3e}) {'ok' if max_abs <= tol else 'FAIL'}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, grid_sample formulation {gs_ms:.4f} ms (err {gs_err:.3e}; not a library "
            f"counterpart), bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB); the samples' taps are "
            f"{taps_gb:.2f} GB through L1 and L2"
            + (f"; the parent's kernel {parent:.4f} ms ({PARENT_K4_CARD})" if parent else "")
        )
        check(max_abs <= tol, f"deform_gather {name} disagrees with its plain version")
        rows_out.append(dict(name=name, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, grid_sample_ms=gs_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        del value, grids, weights, got, want
    torch.cuda.empty_cache()
    return rows_out[0]  # the encoder at the main path's dtype stands for the kernel


# --- phase 14 ----------------------------------------------------------------
def gdino_tokenize(name: str) -> np.ndarray:
    """A class name's WordPiece ids without [CLS]/[SEP], toy vocabulary."""
    return np.asarray(WordPieceTokenizer(toy_vocab()).encode(name)[1:-1])


def make_gdino_pipeline(adapter, sam, cfg: VLFMConfig, capacity, coco=None, non_coco_threshold=None):
    return DetectionPipeline(
        adapter, sam, adapter.make_query_encoder(gdino_tokenize), coco_detector=coco,
        coco_threshold=cfg.coco_threshold,
        non_coco_threshold=cfg.non_coco_threshold if non_coco_threshold is None else non_coco_threshold,
        max_detections=cfg.max_detections_per_frame, sam_frame_capacity=capacity,
    )


def phase_tiny_gdino_pipeline() -> None:
    cfg = VLFMConfig()
    gd_cpu = GroundingDinoDetector.init_random(GroundingDinoConfig.tiny_test(), seed=0, device="cpu")
    sam_cpu = SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device="cpu")
    gd_gpu = GroundingDinoDetector(gd_cpu.cfg, copy.deepcopy(gd_cpu.module).to(DEV))
    sam_gpu = SAM(sam_cpu.cfg, copy.deepcopy(sam_cpu.module).to(DEV))
    rgb = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8))
    per_call = deformable_attentions(gd_cpu.cfg)
    for thr in (None, 0.0):
        want = make_gdino_pipeline(GroundingDinoQueryAdapter(gd_cpu, 64), sam_cpu, cfg, 2, non_coco_threshold=thr)(
            rgb, OPEN_TARGET)
        k40 = counted("K4.launches")
        got = make_gdino_pipeline(GroundingDinoQueryAdapter(gd_gpu, 64), sam_gpu, cfg, 2, non_coco_threshold=thr)(
            rgb.to(DEV), OPEN_TARGET)
        torch.cuda.synchronize()
        k4 = counted("K4.launches") - k40
        (gm, gv, (gx, gs, gc)), (wm, wv, (wx, ws, wc)) = got, want
        box_err = max(float((gx.cpu() - wx).abs().max()), float((gs.cpu() - ws).abs().max()))
        flips = float((gm.cpu() != wm).float().mean())
        log(
            f"[tiny-gdino] {OPEN_TARGET} at threshold {cfg.non_coco_threshold if thr is None else thr}: card vs CPU "
            f"boxes/scores max_abs_err={box_err:.3e} (tol {TINY_GDINO_BOX_ATOL}), valid equal "
            f"{bool(torch.equal(gv.cpu(), wv))}, cls equal {bool(torch.equal(gc.cpu(), wc))}, {int(wv.sum())} "
            f"detections, mask flips {flips:.2e} (tol {TINY_MASK_FLIPS}); K4 {k4} launches (expect {per_call})"
        )
        check(box_err <= TINY_GDINO_BOX_ATOL, "tiny GroundingDINO pipeline boxes differ between card and CPU")
        check(torch.equal(gv.cpu(), wv) and torch.equal(gc.cpu(), wc), "tiny GroundingDINO pipeline valid/cls")
        check(flips <= TINY_MASK_FLIPS, "tiny GroundingDINO pipeline masks differ between card and CPU")
        check(k4 == per_call, "tiny GroundingDINO: one K4 launch per deformable attention")


# --- phase 15 ----------------------------------------------------------------
def build_gdino_path():
    """GroundingDINO SwinT-OGC at full width (``GroundingDinoConfig()``),
    random weights from seed 0 cast to bf16 with the JAX rule, behind the
    pipeline adapter at 800 px."""
    gd = GroundingDinoDetector.init_random(GroundingDinoConfig(), seed=0, device=DEV)
    cast_for_serving(gd.module)
    return gd, GroundingDinoQueryAdapter(gd, image_size=800)


def phase_gdino_path(cfg, adapter, owl, sam, rgb) -> dict:
    b, h, w = rgb.shape[:3]
    k, cap = cfg.max_detections_per_frame, cfg.sam_frame_capacity
    per_pass = chain_launches(sam.cfg.tinyvit)
    coco = CocoDetector(owl, encode_queries, conf_threshold=cfg.coco_threshold, max_detections=k)
    pipe = make_gdino_pipeline(adapter, sam, cfg, cap, coco)
    pipe0 = make_gdino_pipeline(adapter, sam, cfg, cap, coco, non_coco_threshold=0.0)
    runs = [(f"{OPEN_TARGET} at threshold {cfg.non_coco_threshold}", pipe, OPEN_TARGET),
            (f"{OPEN_TARGET} at threshold 0", pipe0, OPEN_TARGET),
            (f"{COCO_TARGET} (COCO route, then the GroundingDINO retry)", pipe, COCO_TARGET)]
    reset_counters()
    t0 = time.perf_counter()
    outs, counts = [], []
    for _, p, target in runs:
        before = (counted("K4.launches"), counted("K1.launches"), counted("K2.launches"))
        outs.append(p(rgb, target))
        torch.cuda.synchronize()
        counts.append([n - n0 for n, n0 in zip((counted("K4.launches"), counted("K1.launches"), counted("K2.launches")),
                                                before)])
    wall = time.perf_counter() - t0
    launches = with_fused(dict(deform_gather=counted("K4.launches"), layer_norm=counted("K1.launches"),
                               mbconv_chain=counted("K2.launches")), "gdino", FUSED_DETECT)

    _, _, _, coco_valid = pipe._coco_path(rgb, COCO_TARGET)
    hit = coco_valid.any(dim=1)
    toilet = COCO_CLASSES.index(COCO_TARGET)
    for (name, _, target), out, (k4, k1, k2) in zip(runs, outs, counts):
        is_coco = target == COCO_TARGET
        frames = check_detections(name, out, b, h, w, k, 80 if is_coco else len(target.split("|")))
        passes = -(-frames // cap)
        _, valid, (_, scores, cls) = out
        log(
            f"[gdino] {name}: {int(valid.sum())} detections on {frames} of {b} frames, {passes} SAM passes, "
            f"top score {float(scores.max()):.4f}; K4 {k4} (expect {K4_PER_DETECT}), "
            f"K1 {k1} (expect {LAUNCHES_DETECT if is_coco else 0}), K2 {k2} (expect {per_pass * passes})"
        )
        check(k4 == K4_PER_DETECT, f"{name}: K4 launch count")
        check(k1 == (LAUNCHES_DETECT if is_coco else 0), f"{name}: K1 launch count")
        check(k2 == per_pass * passes, f"{name}: K2 launches per SAM pass")
        if is_coco:
            # COCO-route frames carry COCO ids; the retried frames, caption phrase 0.
            want_cls = torch.where(hit[:, None], toilet, 0).expand_as(cls)
            check(bool((cls == want_cls)[valid].all()), f"{name}: class ids by route")
            log(f"[gdino] {COCO_TARGET}: the COCO route hit {int(hit.sum())} of {b} frames, the rest took "
                f"GroundingDINO's answer")
    check(check_detections("threshold 0", outs[1], b, h, w, k, 1) == b, "threshold 0 must put detections on every frame")
    log(f"[gdino] wall {wall:.2f} s for the three calls, first calls included")
    return launches


# --- phase 16 ----------------------------------------------------------------
def device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_ms(events) -> float:
    """Union of the device events' intervals, so overlaps count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


K4_KERNEL = "deform_gather_kernel<"  # csrc/deform_gather.cu's kernel template


def phase_gdino_timing(cfg, adapter, sam, rgb, smi: str) -> None:
    pipe = make_gdino_pipeline(adapter, sam, cfg, cfg.sam_frame_capacity)
    ids, mask = pipe._queries(OPEN_TARGET)
    imgs = adapter.preprocess(rgb)
    detect_ms = wall_ms(lambda: adapter.detect(imgs, ids, mask))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        adapter.detect(imgs, ids, mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = device_events(prof)
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    k4 = [e for e in dev if K4_KERNEL in e.name]
    k4_ms = sum(e.time_range.elapsed_us() for e in k4) / 1e3
    busy = busy_ms(dev)
    log(
        f"[gdino-time] B={rgb.shape[0]} GroundingDINO detect: {detect_ms:.2f} ms (wall, median of 10); under "
        f"torch.profiler {wall:.2f} ms wall, {dev_ms:.2f} ms of device time in {len(dev)} device events "
        f"(idle share {1 - busy / wall:.3f}), K4 {len(k4)} launches {k4_ms:.2f} ms "
        f"({k4_ms / max(dev_ms, 1e-9):.3f} of the device time); on {smi}"
    )
    check(len(k4) == K4_PER_DETECT, "the profiler saw one K4 launch per deformable attention")
    ms = wall_ms(lambda: pipe(rgb, OPEN_TARGET))
    log(f"[gdino-time] B={rgb.shape[0]} pipeline call ({OPEN_TARGET}, GroundingDINO, gated SAM): {ms:.2f} ms "
        f"(wall, median of 10) on {smi}")


# --- phase 17 ----------------------------------------------------------------
def launch_profile(fn) -> tuple[int, int, float, float]:
    """(kernels, copies and sets, device busy ms, wall ms) of one call of
    ``fn`` under torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = device_events(prof)
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels), len(dev) - len(kernels), busy_ms(dev), wall


def host_syncs(fn) -> int:
    """Host synchronisations in one call of ``fn``: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, each one caught."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def lane_of(observation: ITM.Observation, lane: int) -> ITM.Observation:
    return ITM.Observation(*(t[lane:lane + 1] for t in observation))


def lanes_equal(state: ITM.PolicyState, lane: int, single: ITM.PolicyState, pointnav_atol: float = 0.0) -> list:
    """Field by field, whether lane ``lane`` of a batched state equals a
    B = 1 state: bit for bit, but the object map's points and the goal
    taken from them to OBJ_POINT_ATOL (a batched matmul's blocking follows
    B) and PointNav's ``h`` and ``c`` to ``pointnav_atol``."""
    out = []
    for name, got, want in zip(state._fields, state, single):
        parts = zip(got._fields, got, want) if isinstance(got, tuple) else [(name, got, want)]
        for field, g, w in parts:
            g = g[:, lane:lane + 1] if name == "pointnav" and field in ("h", "c") else g[lane:lane + 1]
            atol = OBJ_POINT_ATOL if field in ("points", "last_target", "last_goal") else (
                pointnav_atol if field in ("h", "c") else 0.0)
            same = torch.equal(g, w) if atol == 0.0 else bool(((g - w).abs() <= atol).all())
            out.append((f"{name}.{field}", same))
    return out


def phase_batched_spin(engine: PerceptionEngine, spec, cfg, smi: str) -> dict:
    b = BATCH_LANES
    lane_views = [spin_views(SPIN_VIEWS, seed=lane) for lane in range(b)]
    rgb = torch.from_numpy(np.stack([o["rgb"] for views in lane_views for o in views])).to(DEV)
    reset_counters()
    cos = torch.cat([engine.score(rgb[i:i + ITM_BATCH], TARGET) for i in range(0, len(rgb), ITM_BATCH)])
    cos = cos.float().reshape(b, SPIN_VIEWS, -1)
    observations = spin_observations(lane_views, cfg)
    info, state = spin_steps(observations, cos, spec, cfg)
    torch.cuda.synchronize()
    launches = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"))
    calls = len(rgb) // ITM_BATCH
    log(f"[batched] {b} lanes x {SPIN_VIEWS} views (two_room_plan seeds 0-{b - 1}): ITM on {len(rgb)} frames in "
        f"{calls} calls of {ITM_BATCH}; K1 {launches['layer_norm']} (expect {calls * LAUNCHES_IMAGE}), "
        f"K3 {launches['attention']} (expect {calls * ATTN_LAUNCHES_IMAGE})")
    check(launches == dict(layer_norm=calls * LAUNCHES_IMAGE, attention=calls * ATTN_LAUNCHES_IMAGE),
          "batched spin ITM launch counts")
    launches = with_fused(launches, "batched", calls * FUSED_IMAGE)

    # Each lane against a B = 1 run of the same lane, bit for bit.
    for lane in range(b):
        info1, state1 = spin_steps([lane_of(o, lane) for o in observations], cos[lane:lane + 1], spec, cfg)
        same = lanes_equal(state, lane, state1)
        same += [(f"info.{n}", torch.equal(x[lane:lane + 1], y)) for n, x, y in zip(info._fields, info, info1)]
        check(all(ok for _, ok in same), f"batched spin: lane {lane} differs from its B=1 run "
              f"({[n for n, ok in same if not ok]})")
    n_front = state.obstacle.frontiers_valid.sum(dim=1).tolist()
    log(f"[batched] every lane equals its B=1 run bit for bit (grids, frontiers, values, decision; object-map "
        f"points to {OBJ_POINT_ATOL} m); frontiers per lane {n_front}, actions {info.action.tolist()}")
    check(min(n_front) > 0 and bool((info.num_frontiers > 0).all()), "a lane of the batched spin found no frontier")

    # The last view again at B = 1 and B = 8: launches, host syncs, wall and
    # device time of the obstacle-map update alone and of the whole step.
    rows = {}
    for lanes in (1, b):
        obs_lanes = [ITM.Observation(*(t[:lanes] for t in o)) for o in observations]
        info_l, st = spin_steps(obs_lanes, cos[:lanes], spec, cfg)
        st = st._replace(steps=st.steps - 1)
        obs = obs_lanes[-1]
        scfg = dataclasses.replace(cfg, num_init_turns=SPIN_VIEWS - 1)
        k = cfg.max_detections_per_frame
        masks = torch.zeros((lanes, k, *obs.depth.shape[1:]), dtype=torch.bool, device=DEV)
        valid = torch.zeros((lanes, k), dtype=torch.bool, device=DEV)
        keys = threefry.PRNGKey(torch.arange(lanes, device=DEV))

        def om():
            update_obstacles(st.obstacle, spec, cfg, obs.depth, obs.tf_camera_to_episodic, st.steps)

        def policy_step():
            ITM.step(st, obs, cos[:lanes, -1], masks, valid, keys, pointnav="greedy", spec=spec, cfg=scfg)

        def windows():
            rc = spec.to_storage(spec.xy_to_px(obs.robot_xy))
            for arr, window in ((st.value.conf, 256), (st.obstacle.navigable, 224)):
                at = window_index(rc, window, arr.shape[1])
                write_window(arr, read_window(arr, at), at)

        without_host_sync(windows)
        row = {}
        for name, fn in (("obstacle-map update", om), ("policy step (greedy)", policy_step)):
            kernels, copies, busy, wall = launch_profile(fn)
            ms = wall_ms(fn, reps=5, warmup=1)
            row[name] = dict(kernels=kernels, copies=copies, syncs=host_syncs(fn), ms=ms, per_lane=ms / lanes,
                             device_ms=busy, idle=1 - busy / wall)
            r = row[name]
            log(f"[batched-time] B={lanes} {name}: {r['kernels']} kernel launches + {r['copies']} copies/sets, "
                f"{r['syncs']} host syncs, {r['ms']:.2f} ms wall (median of 5), {r['per_lane']:.2f} ms per lane; "
                f"under the profiler {r['device_ms']:.2f} ms of device time, idle share {r['idle']:.3f}; on {smi}")
        rows[lanes] = row
        check(row["policy step (greedy)"]["syncs"] == row["obstacle-map update"]["syncs"],
              f"B={lanes}: the policy step synchronised the host beyond the obstacle map's sweep-loop checks")
        del st, info_l
    return launches


# --- phase 18 ----------------------------------------------------------------
def box_masks(xyxy: torch.Tensor, valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, K, H, W) masks that fill each valid detection's normalized box."""
    rows = torch.arange(h, device=xyxy.device)[:, None] + 0.5
    cols = torch.arange(w, device=xyxy.device)[None, :] + 0.5
    x0, y0, x1, y1 = (xyxy[..., i, None, None] for i in range(4))
    inside = (cols >= x0 * w) & (cols < x1 * w) & (rows >= y0 * h) & (rows < y1 * h)
    return inside & valid[..., None, None]


def object_map_case(name, masks, valid, depth, tf, keys, cfg: VLFMConfig, spec, smi: str) -> int:
    """update_objects on all lanes and on each lane alone; returns the
    accepted detections."""
    b = masks.shape[0]
    robot = tf[:, :2, 3].contiguous()

    def run(lanes):
        objmap = OBJ.create(cfg.object_map_slots, cfg.object_map_points_per_slot, batch=len(lanes), device=DEV)
        return update_objects(objmap, spec, cfg, depth[lanes], masks[lanes], valid[lanes], tf[lanes], robot[lanes],
                              keys[lanes])

    every = list(range(b))
    detected, goal, objmap = run(every)
    inserted = OBJ.update_batch(
        OBJ.create(cfg.object_map_slots, cfg.object_map_points_per_slot, batch=b, device=DEV), keys, depth, masks,
        valid, tf, cfg.camera.min_depth, cfg.camera.max_depth, cfg.camera.fx, cfg.camera.fy,
        erosion_size=cfg.object_map_erosion_size, use_dbscan=cfg.use_object_map_dbscan)
    torch.cuda.synchronize()
    accepted = inserted.slot_used.sum(dim=1)
    log(f"[objmap] {name}: B={b} lanes, {cfg.object_map_slots} slots x {cfg.object_map_points_per_slot} points: "
        f"accepted detections per lane {accepted.tolist()}, cursors {objmap.cursor.tolist()}, has_object "
        f"{detected.int().tolist()}, {int(objmap.point_valid.sum())} valid points after the eviction")
    check(torch.equal(objmap.cursor, accepted.to(torch.int32)) and torch.equal(inserted.cursor, objmap.cursor),
          f"{name}: a lane's cursor differs from its count of accepted detections")
    check(bool((accepted <= valid.sum(dim=1)).all()), f"{name}: more accepted detections than valid masks")
    check(bool(torch.isfinite(objmap.points).all() and torch.isfinite(goal).all()), f"{name}: points finite")
    check(torch.equal(OBJ.has_object(inserted), accepted > 0), f"{name}: has_object where a detection was accepted")
    worst = 0.0
    for lane in every:
        d1, g1, o1 = run([lane])
        for field in ("point_valid", "point_in_range", "slot_used", "cursor", "has_last_target"):
            check(torch.equal(getattr(objmap, field)[lane], getattr(o1, field)[0]), f"{name} lane {lane}: {field}")
        check(bool(detected[lane] == d1[0]), f"{name} lane {lane}: has_object")
        worst = max(worst, float((objmap.points[lane] - o1.points[0]).abs().max()),
                    float((goal[lane] - g1[0]).abs().max()))
    log(f"[objmap] {name}: B={b} equals B=1 per lane, slots and validity exactly, points within {worst:.3e} m "
        f"(tol {OBJ_POINT_ATOL})")
    check(worst <= OBJ_POINT_ATOL, f"{name}: the object map at B={b} differs from B=1")
    ms = wall_ms(lambda: run(every), reps=5, warmup=1)
    _, _, busy, wall = launch_profile(lambda: run(every))
    log(f"[objmap-time] {name}: update_objects at B={b}: {ms:.2f} ms wall (median of 5); under the profiler "
        f"{busy:.2f} ms of device time, idle share {1 - busy / wall:.3f}; on {smi}")
    return int(accepted.sum())


def phase_object_map(det_cfg, det, sam, smi: str) -> dict:
    b = DET_BATCH
    cfg = VLFMConfig()
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    views = spin_views(b)
    rgb = torch.from_numpy(np.stack([o["rgb"] for o in views])).to(DEV)
    pipe = make_pipeline(det, sam, det_cfg, det_cfg.sam_frame_capacity, non_coco_threshold=0.0)
    reset_counters()
    masks, valid, (xyxy, _, _) = pipe(rgb, OPEN_TARGET)
    torch.cuda.synchronize()
    launches = dict(layer_norm=counted("K1.launches"), mbconv_chain=counted("K2.launches"))
    h, w = rgb.shape[1:3]
    check(masks.shape == (b, det_cfg.max_detections_per_frame, h, w), "object-map masks shape")
    passes = -(-int(valid.any(dim=1).sum()) // det_cfg.sam_frame_capacity)
    check(launches == dict(layer_norm=LAUNCHES_DETECT, mbconv_chain=chain_launches(sam.cfg.tinyvit) * passes),
          "object-map masks: K1 and K2 launch counts")
    launches = with_fused(launches, "objmap", FUSED_DETECT)
    log(f"[objmap] masks {tuple(masks.shape)} from the {OPEN_TARGET} pipeline call at threshold 0: {int(valid.sum())} "
        f"valid, mean coverage {float(masks.float().mean()):.3f}; K1 {launches['layer_norm']}, K2 "
        f"{launches['mbconv_chain']} launches")
    inputs = view_inputs(views, cfg, DEV)
    tf = torch.cat([t for t, _ in inputs])
    depth = torch.cat([d for _, d in inputs])
    lanes = torch.arange(b, device=DEV)
    steps = lanes  # lane i holds view i of the spin, taken at step i
    keys = threefry.fold_in(threefry.PRNGKey(lanes), steps)
    erosion = 2 * cfg.object_map_erosion_size + 1
    sam = object_map_case("gated SAM's masks", masks, valid, depth, tf, keys, cfg, spec, smi)
    log(f"[objmap] gated SAM's masks: {sam} accepted (expect 0: random SAM weights give speckle that the "
        f"{erosion}x{erosion} erosion clears, so this case's B=8-equals-B=1 check compares empty maps)")
    check(sam == 0, "gated SAM's random-weight masks were accepted into the object map")
    boxed = object_map_case("the same detections' boxes as masks", box_masks(xyxy, valid, h, w), valid, depth, tf,
                            keys, cfg, spec, smi)
    log(f"[objmap] the same detections' boxes as masks: {boxed} accepted (expect > 0: they carry points through "
        f"every step of the map)")
    check(boxed > 0, "no box mask was accepted into the object map")
    return launches


# --- phase 19 ----------------------------------------------------------------
def near_tie(logits: torch.Tensor) -> bool:
    """Whether a (4,) logit row's top two lie within PN_ATOL."""
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]) <= PN_ATOL


def step_timings(name, lanes, fn, smi) -> dict:
    """Wall (median of 5), device time and idle share (torch.profiler),
    launches and host syncs of one call of ``fn``; env-steps/s."""
    kernels, copies, busy, wall = launch_profile(fn)
    ms = wall_ms(fn, reps=5, warmup=1)
    r = dict(kernels=kernels, copies=copies, ms=ms, device_ms=busy, idle=1 - busy / wall,
             syncs=host_syncs(fn), steps_per_s=lanes / ms * 1e3)
    log(f"[episodes-time] B={lanes} {name}: {r['ms']:.2f} ms wall (median of 5), {r['steps_per_s']:.1f} "
        f"env-steps/s; under the profiler {r['device_ms']:.2f} ms of device time, idle share {r['idle']:.3f}; "
        f"{r['kernels']} kernel launches + {r['copies']} copies/sets, {r['syncs']} host syncs; on {smi}")
    return r


def phase_batched_episodes(engine: PerceptionEngine, spec, cfg, smi: str) -> dict:
    b = BATCH_LANES
    pointnav = PointNavPolicy.init_random(seed=0, depth_shape=tuple(cfg.depth_image_shape), device=DEV)
    envs = [FakeObjectNavEnv(two_room_plan(seed=lane), EnvConfig()) for lane in range(b)]
    obs_list = [e.reset() for e in envs]
    engine.text_features(TARGET)  # cached before the counts
    state = ITM.create_state(spec, cfg, batch=b, device=DEV)
    rng = threefry.PRNGKey(0, device=DEV)
    record, loop_ms = [], []
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(EPISODE_STEPS):
        t_step = time.perf_counter()
        obs, _, masks, valid = step_inputs(obs_list, cfg, DEV)
        rgb = torch.from_numpy(np.stack([o["rgb"] for o in obs_list])).to(DEV)
        cos = engine.score(rgb, TARGET).float()
        rng, sub = threefry.split(rng)
        keys = threefry.split(sub, b)
        action, info, state = ITM.step(state, obs, cos, masks, valid, keys, pointnav=pointnav, spec=spec, cfg=cfg)
        # PointNav with random weights only turns in place. So the
        # environments steer by the greedy rule toward the goal that step
        # chose (its STOPs and the spin kept), and the maps, frontiers and
        # modes are those of a moving agent; step still runs PointNav.
        drive = torch.where((info.mode != ITM.MODE_INITIALIZE) & (action != ITM.STOP),
                            ITM.greedy_action(info.theta), action)
        back = read_back(drive, info)
        record.append(dict(inputs=(obs, cos, masks, valid, keys), info=info, fxy=state.obstacle.frontiers_xy,
                           logits=pointnav.logits(state.pointnav), h=state.pointnav.h, c=state.pointnav.c, rgb=rgb,
                           drive=back[:, 0].astype(int)))
        for i, env in enumerate(envs):
            if not obs_list[i]["done"]:  # a finished episode idles, as JAX's batched driver
                obs_list[i] = env.step(int(back[i, 0]))
        loop_ms.append((time.perf_counter() - t_step) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"))
    sweep_launches = dict(flood=counted("flood.launches"), label=counted("label.launches"))
    modes = torch.stack([r["info"].mode for r in record]).cpu()
    n_front = torch.stack([r["info"].num_frontiers for r in record]).cpu()
    actions = torch.stack([r["info"].action for r in record]).cpu()
    cosines = torch.stack([r["inputs"][1] for r in record]).cpu()
    log(f"[episodes] {b} lanes of two_room_plan seeds 0-{b - 1} at {EnvConfig().width}x{EnvConfig().height}, "
        f"{EPISODE_STEPS} steps of ITM (B={b}, one call a step) + the policy step (v2, PointNav ResNet-18 GN + "
        f"2x512 LSTM at {cfg.depth_image_shape[0]}x{cfg.depth_image_shape[1]}, f32), the environments steered by "
        f"the greedy rule toward step's goal: {wall:.2f} s incl. first calls; "
        f"K1 {launches['layer_norm']} (expect {EPISODE_STEPS * LAUNCHES_IMAGE}), K3 {launches['attention']} "
        f"(expect {EPISODE_STEPS * ATTN_LAUNCHES_IMAGE})")
    check(cosines.shape == (EPISODE_STEPS, b, cfg.value_channels) and bool(torch.isfinite(cosines).all()),
          "batched episodes: ITM cosines not finite or of the wrong shape")
    loop = float(np.median(loop_ms[1:]))
    log(f"[episodes] the closed loop (ITM, step, one read back, the {b} environments' steps and frames on the "
        f"host): {loop:.2f} ms per env step (median of steps 2-{EPISODE_STEPS}), {b / loop * 1e3:.1f} env-steps/s; "
        f"on {smi}")
    log(f"[episodes] modes per step (rows lanes): {modes.T.tolist()}")
    log(f"[episodes] PointNav's actions per step (rows lanes): {actions.T.tolist()}")
    log(f"[episodes] the environments' actions per step (rows lanes): "
        f"{np.stack([r['drive'] for r in record]).T.tolist()}; done {[o['done'] for o in obs_list]}, "
        f"success {[e.called_stop and o['distance_to_goal'] <= e.cfg.success_radius for e, o in zip(envs, obs_list)]}, "
        f"path lengths {[round(e.path_length, 2) for e in envs]} m")
    check(any(e.path_length > 0 for e in envs), "no lane of the batched episodes moved")
    check(launches == dict(layer_norm=EPISODE_STEPS * LAUNCHES_IMAGE, attention=EPISODE_STEPS * ATTN_LAUNCHES_IMAGE),
          "batched episodes: K1 and K3 launch counts")
    launches = {**with_fused(launches, "episodes", EPISODE_STEPS * FUSED_IMAGE), **sweep_launches}
    log(f"[episodes] flood and labelling kernels: {sweep_launches} launches")
    check(sweep_launches == dict(flood=EPISODE_STEPS, label=EPISODE_STEPS),
          "batched episodes: one flood and one labelling launch a step")
    init = cfg.num_init_turns
    check(bool((modes[:init] == ITM.MODE_INITIALIZE).all() and (modes[init] != ITM.MODE_INITIALIZE).all()),
          f"a lane did not leave INITIALIZE after exactly {init} steps")
    check(bool(((modes[init:] == ITM.MODE_EXPLORE) & (n_front[init:] > 0)).any()),
          "no lane reached EXPLORE with a valid frontier")

    # Each lane against a B = 1 replay of its recorded inputs.
    near, flipped, worst, singles = 0, 0, 0.0, []
    for lane in range(b):
        st = ITM.create_state(spec, cfg, device=DEV)
        diverged = False
        for k, r in enumerate(record):
            obs, cos, masks, valid, keys = r["inputs"]
            sl = slice(lane, lane + 1)
            _, i1, st = ITM.step(st, lane_of(obs, lane), cos[sl], masks[sl], valid[sl], keys[sl], pointnav=pointnav,
                                 spec=spec, cfg=cfg)
            info = r["info"]
            for name in ("mode", "num_frontiers", "target_detected", "stop_called", "best_value"):
                check(torch.equal(getattr(info, name)[sl], getattr(i1, name)), f"lane {lane} step {k}: {name}")
            check(torch.equal(r["fxy"][sl], st.obstacle.frontiers_xy), f"lane {lane} step {k}: frontiers")
            check(bool(((info.goal[sl] - i1.goal).abs() <= OBJ_POINT_ATOL).all()), f"lane {lane} step {k}: goal")
            logits1 = pointnav.logits(st.pointnav)
            tie = near_tie(logits1[0])
            near += tie
            if not diverged and not torch.equal(info.action[sl], i1.action):
                check(tie, f"lane {lane} step {k}: actions differ off a near tie")
                flipped += 1
                diverged = True  # the runs' PointNav states part from here; their maps do not
            if not diverged:
                err = max(float((r[n][:, sl] - getattr(st.pointnav, n)).abs().max()) for n in ("h", "c"))
                err = max(err, float((r["logits"][sl] - logits1).abs().max()))
                check(err <= PN_ATOL, f"lane {lane} step {k}: PointNav differs by {err:.3e} (tol {PN_ATOL})")
                worst = max(worst, err)
        same = [(n, ok) for n, ok in lanes_equal(state, lane, st, pointnav_atol=PN_ATOL)
                if not (diverged and n.startswith("pointnav."))]
        check(all(ok for _, ok in same), f"batched episodes: lane {lane} differs from its B=1 replay "
              f"({[n for n, ok in same if not ok]})")
        singles.append(st)
    log(f"[episodes] every lane equals its B=1 replay: grids, values, frontiers, object-map slots, modes bit for "
        f"bit; object-map points and goals within {OBJ_POINT_ATOL} m; PointNav logits and h/c within {worst:.3e} "
        f"(tol {PN_ATOL}); near-tie steps {near} of {b * EPISODE_STEPS}, actions flipped at them {flipped}")

    # One batched step at B = 8 and at B = 1 (lane 0), on the last step's
    # inputs at a step count with no full prune (7 steps of 8): the step
    # alone and ITM + step; PointNav's act alone.
    obs, cos, masks, valid, keys = record[-1]["inputs"]
    rgb = record[-1]["rgb"]
    rows = {}
    for lanes, st in ((b, state), (1, singles[0])):
        st = st._replace(steps=st.steps + 1)
        sl = slice(0, lanes)
        o = ITM.Observation(*(t[sl] for t in obs))

        def policy_step():
            ITM.step(st, o, cos[sl], masks[sl], valid[sl], keys[sl], pointnav=pointnav, spec=spec, cfg=cfg)

        def itm_and_step():
            c = engine.score(rgb[sl], TARGET).float()
            ITM.step(st, o, c, masks[sl], valid[sl], keys[sl], pointnav=pointnav, spec=spec, cfg=cfg)

        def om():
            update_obstacles(st.obstacle, spec, cfg, o.depth, o.tf_camera_to_episodic, st.steps)

        nav_depth = resize_area(o.depth, tuple(cfg.depth_image_shape))
        goal = torch.stack([record[-1]["info"].rho[sl], record[-1]["info"].theta[sl]], dim=-1)
        rows[lanes] = dict(
            step=step_timings("policy step (v2, PointNav)", lanes, policy_step, smi),
            itm_step=step_timings("ITM + policy step", lanes, itm_and_step, smi),
            obstacle=step_timings("its obstacle-map update alone", lanes, om, smi),
            act=step_timings("PointNav act alone", lanes, lambda: pointnav.act(nav_depth, goal, st.pointnav), smi),
        )
        check(rows[lanes]["step"]["syncs"] == rows[lanes]["obstacle"]["syncs"],
              f"B={lanes}: the policy step synchronised the host beyond the obstacle map's sweep-loop checks")
    log(f"[episodes-time] env-steps/s of the batched step: {rows[b]['step']['steps_per_s']:.1f} at B={b} against "
        f"{rows[1]['step']['steps_per_s']:.1f} at B=1 (step alone); {rows[b]['itm_step']['steps_per_s']:.1f} against "
        f"{rows[1]['itm_step']['steps_per_s']:.1f} with ITM; on {smi}")

    # The recycled driver on the card against fresh single episodes.
    seeds = list(range(FARM_EPISODES))

    def factory(seed):
        return FakeObjectNavEnv(open_room_plan(seed=seed), EnvConfig())

    recycled, stats = run_episodes_recycled(factory, seeds, lanes=b, pointnav="greedy", spec=spec, cfg=cfg,
                                            max_steps=EPISODE_STEPS, device=DEV)
    check(set(recycled) == set(seeds), "the recycled driver lost an episode")
    for seed in seeds:
        fresh, _ = run_episode(factory(seed), "greedy", spec, cfg, seed=seed, max_steps=EPISODE_STEPS, device=DEV)
        got, want = dataclasses.asdict(recycled[seed]), dataclasses.asdict(fresh)
        for key in ("spl", "soft_spl", "path_length", "distance_to_goal"):
            check(abs(got.pop(key) - want.pop(key)) <= 1e-6, f"recycled seed {seed}: {key}")
        check(got == want, f"recycled seed {seed}: {got} against a fresh run's {want}")
    res = [recycled[s] for s in seeds]
    log(f"[episodes] run_episodes_recycled: {len(seeds)} open_room_plan episodes on {b} lanes (greedy, env cosines, "
        f"at most {EPISODE_STEPS} steps) equal fresh run_episode runs on the card; {stats.env_steps} env steps in "
        f"{stats.wall_time:.2f} s ({stats.steps_per_sec:.1f} env-steps/s, host rendering included); successes "
        f"{sum(r.success for r in res)}, steps {[r.steps for r in res]}; on {smi}")
    return launches, recycled


# --- phase 20 ----------------------------------------------------------------
class CountingPipeline:
    """The full stack's detection pipeline, recording each call's frames
    with a detection as a device tensor (no host read until the run ends)."""

    def __init__(self, pipe):
        self.pipe, self.frames = pipe, []

    def __call__(self, rgb, target, out_hw=None):
        out = self.pipe(rgb, target, out_hw)
        self.frames.append(out[1].any(dim=1).sum())
        return out

    def __getattr__(self, name):
        return getattr(self.pipe, name)


def full_stack_layout(lanes: int, h: int, w: int) -> packing.Layout:
    """The perception farm's packed layout for its lanes (f32 full-size
    depth, full-size frames)."""
    return packing.build_layout([("depth", "float32", (lanes, h, w)), ("rgb", "uint8", (lanes, h, w, 3)),
                                 ("heading", "float32", (lanes,)), ("xy", "float32", (lanes, 2)),
                                 ("seeds", "int32", (lanes,)), ("steps", "int32", (lanes,)),
                                 ("reset", "uint8", (lanes,))])


def lane_state(state: ITM.PolicyState, lane: int) -> ITM.PolicyState:
    """A B = 1 copy of one lane of a batched state."""
    def take(name, field, t):
        return (t[:, lane:lane + 1] if name == "pointnav" and field in ("h", "c") else t[lane:lane + 1]).clone()

    return ITM.PolicyState(*(type(v)(*(take(n, f, t) for f, t in zip(v._fields, v))) if isinstance(v, tuple)
                             else take(n, n, v) for n, v in zip(state._fields, state)))


def phase_full_stack(engine: PerceptionEngine, det, sam, spec, recycled: dict, smi: str) -> dict:
    b = BATCH_LANES
    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=SAM_CAPACITY)
    env_cfg = EnvConfig()
    h, w = env_cfg.height, env_cfg.width
    pointnav = PointNavPolicy.init_random(seed=0, depth_shape=tuple(cfg.depth_image_shape), device=DEV)
    perception = FullStackPerception(cfg, itm=engine.itm, detector=det, sam=sam,
                                     det_threshold=cfg.non_coco_threshold, device=DEV)
    counter = perception.pipeline = CountingPipeline(perception.pipeline)
    layout = full_stack_layout(b, h, w)
    packed = perception.make_fused_step(pointnav, spec, cfg, COCO_TARGET, layout=layout)
    unpacked = perception.make_fused_step(pointnav, spec, cfg, COCO_TARGET)
    check(perception.make_fused_step(pointnav, spec, cfg, COCO_TARGET, layout=layout) is packed,
          "make_fused_step did not cache its callable")
    buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
    views = packing.pack_views(buf.numpy(), layout)
    envs = [FakeObjectNavEnv(two_room_plan(seed=lane), env_cfg) for lane in range(b)]
    obs_list = [e.reset() for e in envs]
    perception.engine.text_features(COCO_TARGET)  # cached before the counts
    perception.pipeline._queries(COCO_TARGET)
    perception.pipeline.coco_detector._coco_queries()
    state = ITM.create_state(spec, cfg, batch=b, device=DEV)
    record, loop_ms = [], []
    reset_counters()
    t0 = time.perf_counter()
    for k in range(EPISODE_STEPS):
        t_step = time.perf_counter()
        for j, o in enumerate(obs_list):
            views["depth"][j], views["rgb"][j] = o["depth"], o["rgb"]
            views["heading"][j], views["xy"][j] = o["heading"], o["robot_xy"]
        views["seeds"][:], views["steps"][:], views["reset"][:] = np.arange(b), k, 0
        inputs = {name: v.copy() for name, v in views.items()}
        out, state = packed(state, None, buf)  # one pinned copy in
        out_np = out.cpu().numpy()  # one (8, 4) read back
        record.append(dict(inputs=inputs, out=out))
        # Random PointNav only turns: past the spin, the environments steer
        # by the greedy rule toward step's goal (its STOPs kept), as in
        # phase 19; the replay below feeds the recorded inputs.
        actions = out_np[:, 0].astype(np.int64)
        _, theta = rho_theta(torch.from_numpy(inputs["xy"]), torch.from_numpy(inputs["heading"]),
                             torch.from_numpy(out_np[:, 2:].copy()))
        drive = np.where((k >= cfg.num_init_turns) & (actions != ITM.STOP), ITM.greedy_action(theta).numpy(),
                         actions)
        for i, env in enumerate(envs):
            if not obs_list[i]["done"]:  # a finished episode idles
                obs_list[i] = env.step(int(drive[i]))
        loop_ms.append((time.perf_counter() - t_step) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"),
                    mbconv_chain=counted("K2.launches"))
    sweep_launches = dict(flood=counted("flood.launches"), label=counted("label.launches"))
    frames = [int(f) for f in counter.frames]
    per_pass = chain_launches(sam.cfg.tinyvit)
    passes = [-(-f // SAM_CAPACITY) for f in frames]
    detected = np.stack([r["out"][:, 1].cpu().numpy() for r in record])
    ln_step = LAUNCHES_IMAGE + 2 * LAUNCHES_DETECT  # ITM's image branch, OWL-ViT twice (COCO prompts, the retry)
    log(f"[full-stack] {b} lanes of two_room_plan seeds 0-{b - 1} at {w}x{h}, {EPISODE_STEPS} fused dispatches "
        f"(one pinned copy of {layout.total} bytes in, one ({b}, 4) read back): BLIP2-ITM, OWL-ViT with the COCO "
        f"route ({COCO_TARGET}, thresholds {cfg.coco_threshold}/{cfg.non_coco_threshold}), MobileSAM gated at "
        f"{SAM_CAPACITY} frames, step v2 with PointNav: {wall:.2f} s incl. first calls; frames with a detection "
        f"{sum(frames)} of {b * EPISODE_STEPS}, SAM passes {sum(passes)}; lanes with target_detected per step "
        f"{detected.sum(axis=1).astype(int).tolist()}; K1 {launches['layer_norm']} (expect "
        f"{EPISODE_STEPS * ln_step}), K3 {launches['attention']} (expect {EPISODE_STEPS * ATTN_LAUNCHES_IMAGE}), "
        f"K2 {launches['mbconv_chain']} (expect {per_pass * sum(passes)})")
    check(launches == dict(layer_norm=EPISODE_STEPS * ln_step, attention=EPISODE_STEPS * ATTN_LAUNCHES_IMAGE,
                           mbconv_chain=per_pass * sum(passes)), "full stack: K1, K3 and K2 launch counts")
    launches = {**with_fused(launches, "full-stack", EPISODE_STEPS * FUSED_STEP), **sweep_launches}
    log(f"[full-stack] flood and labelling kernels: {sweep_launches} launches, counted on the device (replays "
        f"included)")
    check(sweep_launches == dict(flood=EPISODE_STEPS, label=EPISODE_STEPS),
          "full stack: one flood and one labelling launch a dispatch")
    check(len(frames) == EPISODE_STEPS and sum(frames) > 0, "full stack: no frame detected")
    loop = float(np.median(loop_ms[1:]))
    log(f"[full-stack] the closed loop (fill the pinned buffer, the fused dispatch, its read back, the {b} "
        f"environments' steps and frames on the host): {loop:.2f} ms per env step (median of steps "
        f"2-{EPISODE_STEPS}), {b / loop * 1e3:.1f} env-steps/s; path lengths "
        f"{[round(e.path_length, 2) for e in envs]} m; on {smi}")
    check(any(e.path_length > 0 for e in envs), "no lane of the full stack moved")

    # The same run through the unpacked signature, at the same B, bit for bit.
    st = ITM.create_state(spec, cfg, batch=b, device=DEV)
    names = ("reset", "depth", "heading", "xy", "rgb", "seeds", "steps")
    for k, r in enumerate(record):
        action, det_flag, goal, st = unpacked(st, None, *(r["inputs"][n] for n in names))
        got = torch.cat([action[:, None].float(), det_flag[:, None].float(), goal], dim=1)
        check(torch.equal(got, r["out"]), f"full stack step {k}: unpacked outputs differ from packed "
              f"({(got != r['out']).sum().item()} values)")
    log(f"[full-stack] the unpacked signature (7 copies in, 3 reads out) gives every lane's actions, detected "
        f"flags and goals bit for bit over the {EPISODE_STEPS} steps")

    # One fused dispatch at B = 8 and at B = 1 (lane 0), at a step count
    # with no full prune, against ``batch`` alone at the same B.
    one = full_stack_layout(1, h, w)
    packed1 = perception.make_fused_step(pointnav, spec, cfg, COCO_TARGET, layout=one)
    buf1 = torch.empty(one.total, dtype=torch.uint8, pin_memory=True)
    views1 = packing.pack_views(buf1.numpy(), one)
    for name, v in views1.items():
        v[...] = record[-1]["inputs"][name][:1]
    rgb = torch.from_numpy(record[-1]["inputs"]["rgb"]).to(DEV)
    rows = {}
    for lanes, fused, bufl, st in ((b, packed, buf, state), (1, packed1, buf1, lane_state(state, 0))):
        st = st._replace(steps=st.steps + 1)
        rows[lanes] = dict(
            dispatch=step_timings("fused dispatch (one copy in, one read out)", lanes,
                                  lambda: fused(st, None, bufl)[0].cpu(), smi),
            batch=step_timings("FullStackPerception.batch alone", lanes,
                               lambda: perception.batch(rgb[:lanes], COCO_TARGET), smi),
        )
        d, p = rows[lanes]["dispatch"], rows[lanes]["batch"]
        log(f"[full-stack-time] B={lanes}: {layout.total if lanes == b else one.total} bytes per dispatch; "
            f"perception is {p['ms'] / d['ms']:.3f} of the dispatch's wall time and {p['device_ms'] / d['device_ms']:.3f} "
            f"of its device time; on {smi}")
    log(f"[full-stack-time] env-steps/s of the fused dispatch: {rows[b]['dispatch']['steps_per_s']:.1f} at B={b}, "
        f"{rows[1]['dispatch']['steps_per_s']:.1f} at B=1; on {smi}")

    # The farm: sim worker processes over the shared-memory ring, packed.
    seeds = list(range(FARM_EPISODES))
    farm_kw = dict(lanes=b, pointnav="greedy", spec=spec, cfg=cfg, plan_name="open_room_plan", env_cfg=env_cfg,
                   workers=FARM_WORKERS, max_steps=EPISODE_STEPS)
    oracle, ostats = run_episodes_farm(seeds, device=DEV, **farm_kw)
    check(set(oracle) == set(seeds), "the oracle farm lost an episode")
    for seed in seeds:
        got, want = dataclasses.asdict(oracle[seed]), dataclasses.asdict(recycled[seed])
        for key in ("spl", "soft_spl", "path_length", "distance_to_goal"):
            check(abs(got.pop(key) - want.pop(key)) <= 1e-6, f"oracle farm seed {seed}: {key}")
        check(got == want, f"oracle farm seed {seed}: {got} against the recycled driver's {want}")
    log(f"[farm] oracle farm: {FARM_EPISODES} open_room_plan episodes on {b} lanes ({FARM_WORKERS} workers, one "
        f"dispatch over all lanes, greedy) equal run_episodes_recycled field for field; "
        f"{farm_summary(ostats)}; on {smi}")
    # The full stack's farm with f32 full-size records, then with the JAX
    # bench's transport (bench.py:809, :825): u16 half-size depth and
    # half-size RGB, dequantised and brought to the camera grid on the card.
    for label, transport in (("f32 full-size", {}),
                             ("u16 half-size depth, half-size RGB", dict(depth_u16=True, depth_half=True,
                                                                         rgb_half=True))):
        counter.frames.clear()
        full_seeds = seeds[:FULL_FARM_EPISODES]
        full, fstats = run_episodes_farm(full_seeds, perception=perception, target=COCO_TARGET,
                                         **{**farm_kw, "max_steps": FULL_FARM_STEPS}, **transport)
        check(set(full) == set(full_seeds), f"the full-stack farm ({label}) lost an episode")
        res = [full[s] for s in full_seeds]
        # INITIALIZE is exactly num_init_turns steps, and an episode ends
        # early only on a STOP, which INITIALIZE never gives.
        check(all(r.steps > cfg.num_init_turns for r in res),
              f"the full-stack farm ({label}): an episode ended before it left INITIALIZE")
        log(f"[farm] full-stack farm, {label} records: the first {FULL_FARM_EPISODES} of those episodes (at most "
            f"{FULL_FARM_STEPS} steps, the {cfg.num_init_turns}-turn spin then the policy) with BLIP2-ITM, OWL-ViT "
            f"and gated SAM per dispatch: all finished past the spin, successes {sum(r.success for r in res)}, steps "
            f"{[r.steps for r in res]}, path lengths {[round(r.path_length, 3) for r in res]} m, detected "
            f"{sum(r.target_detected for r in res)}; frames with a detection "
            f"{sum(int(f) for f in counter.frames)}; {farm_summary(fstats)}; on {smi}")
    return launches, oracle, record


# --- phase 21 ----------------------------------------------------------------
def question_encoder(vocab_size: int):
    """The full stack's question tokens: toy WordPiece ids (8 tokens)
    modulo T5's vocabulary."""
    tok = WordPieceTokenizer(toy_vocab(), max_len=8)

    def encode(text):
        ids, mask = tok.encode_batch([text])
        return ids[0] % vocab_size, mask[0]

    return encode


def make_veto(bridge: BLIP2VQA, yes: int, capacity=None) -> VQAVeto:
    return VQAVeto(vqa=bridge.t5, encode_text=question_encoder(bridge.cfg.t5.vocab_size), yes_token_id=yes,
                   image_prefix=lambda rgb: bridge.image_prefix(bridge.preprocess(rgb)),
                   max_answer_tokens=VQA_TOKENS, slot_capacity=capacity)


@torch.inference_mode()
def first_logits(veto: VQAVeto, images: torch.Tensor, phrase: str) -> torch.Tensor:
    """(N, vocab) logits of the first answer token of annotated frames, as
    ``veto.vqa.generate`` computes them for one batch of N."""
    ids, mask = veto._question_tokens(phrase)
    n = images.shape[0]
    t5 = veto.vqa
    with exact_f32(images.device):
        enc, m = t5.module.encode(ids.expand(n, -1), mask.expand(n, -1), veto.image_prefix(images))
        tokens = torch.zeros((n, veto.max_answer_tokens + 1), dtype=torch.int64, device=images.device)
        return t5.module.decode_logits(tokens, enc, m)[:, 0].float()


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def phase_tiny_vqa() -> None:
    """A tiny BLIP2VQA and its veto, the same f32 weights on the CPU and the
    card: the bucket tables, the visual prefix, the first-token logits, the
    tokens away from near ties, and the vetoes."""
    cfg = BLIP2VQAConfig.tiny()
    cpu = BLIP2VQA.init_random(cfg, seed=0, device="cpu")
    gpu = BLIP2VQA(cfg, copy.deepcopy(cpu.module).to(DEV), type(cpu.t5)(cfg.t5, copy.deepcopy(cpu.t5.module).to(DEV)))
    for lq, lk, bidir in ((16, 16, True), (VQA_TOKENS + 1, VQA_TOKENS + 1, False), (300, 300, True), (300, 300, False)):
        same = torch.equal(bucket_table(lq, lk, bidir, 32, 128, DEV).cpu(),
                           bucket_table(lq, lk, bidir, 32, 128, torch.device("cpu")))
        check(same, f"bucket table {lq}x{lk} bidirectional={bidir}: card differs from CPU")
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8))
    masks = torch.zeros((3, 2, 48, 64), dtype=torch.bool)
    for i in range(3):
        masks[i, 0, 8 + 4 * i:30, 10:40 - 3 * i] = True
        masks[i, 1, 20:44, 30 + 2 * i:60] = True
    valid = torch.tensor([[True, False], [True, True], [False, True]])
    veto_cpu, veto_gpu = make_veto(cpu, 0), make_veto(gpu, 0)
    imgs_cpu = veto_cpu.annotate(rgb, masks)
    imgs_gpu = veto_gpu.annotate(rgb.to(DEV), masks.to(DEV))
    check(torch.equal(imgs_gpu.cpu(), imgs_cpu), "tiny veto: annotated frames differ between card and CPU")
    prefix_err = float((gpu.image_prefix(gpu.preprocess(imgs_gpu)).cpu()
                        - cpu.image_prefix(cpu.preprocess(imgs_cpu))).abs().max())
    lc = first_logits(veto_cpu, imgs_cpu, COCO_TARGET)
    lg = first_logits(veto_gpu, imgs_gpu, COCO_TARGET).cpu()
    logit_err = float((lg - lc).abs().max())
    decided = top2_margin(lc) > 2 * TINY_VQA_ATOL
    tokens_equal = torch.equal(lg.argmax(-1)[decided], lc.argmax(-1)[decided])
    yes = int(lc.argmax(-1)[0])  # the answer slot 0 gets: some slots keep, some drop
    for cap in (None, 2):
        want = make_veto(cpu, yes, cap)(rgb, masks, valid, COCO_TARGET)
        got = make_veto(gpu, yes, cap)(rgb.to(DEV), masks.to(DEV), valid.to(DEV), COCO_TARGET).cpu()
        check(torch.equal(got[decided.reshape(3, 2)], want[decided.reshape(3, 2)]),
              f"tiny veto (capacity {cap}): card differs from CPU off near ties")
    log(f"[tiny-vqa] bucket tables equal card and CPU (16x16, 5x5, 300x300, both directions); prefix "
        f"max_abs_err={prefix_err:.3e}, first-token logits max_abs_err={logit_err:.3e} (tol {TINY_VQA_ATOL}); "
        f"tokens equal on the {int(decided.sum())} of {len(decided)} slots off near ties: {tokens_equal}; "
        f"vetoes equal, dense and at capacity 2 (yes = {yes}: kept {int(want.sum())} of {int(valid.sum())})")
    check(prefix_err <= TINY_VQA_ATOL and logit_err <= TINY_VQA_ATOL, "tiny VQA: card differs from CPU")
    check(tokens_equal, "tiny VQA: first tokens differ off near ties")


def build_vqa_bridge() -> BLIP2VQA:
    """BLIP-2 flan-T5-XL at full width (EVA ViT-g 224 px, the Q-Former with
    32 queries, flan-t5-xl) with random weights from seed 0 drawn on the
    card, served bf16 under cast_for_serving."""
    bridge = BLIP2VQA.init_random(BLIP2VQAConfig.production(), seed=0, device=DEV)
    cast_for_serving(bridge.module)
    cast_for_serving(bridge.t5.module)
    return bridge


def veto_slots(b: int, k: int, h: int, w: int, density: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, K, H, W) box masks from a seeded generator and (B, K) validity
    with ``density`` valid slots, the first density // B of each frame."""
    gen = torch.Generator(device=DEV).manual_seed(21)
    lo = torch.rand((b, k, 2), generator=gen, device=DEV) * 0.6
    size = 0.1 + torch.rand((b, k, 2), generator=gen, device=DEV) * 0.3
    xyxy = torch.cat([lo, lo + size], dim=-1)  # x0, y0, x1, y1
    valid = (torch.arange(k, device=DEV) < density // b).expand(b, k).contiguous()
    return box_masks(xyxy, torch.ones_like(valid), h, w), valid


def timed(label: str, fn, smi: str) -> dict:
    """Wall (median of 5), device time and idle share (torch.profiler),
    launches and host syncs of one call of ``fn``."""
    kernels, copies, busy, wall = launch_profile(fn)
    r = dict(kernels=kernels, copies=copies, ms=wall_ms(fn, reps=5, warmup=1), device_ms=busy, idle=1 - busy / wall,
             syncs=host_syncs(fn))
    log(f"[vqa-time] {label}: {r['ms']:.2f} ms wall (median of 5); under the profiler {r['device_ms']:.2f} ms of "
        f"device time, idle share {r['idle']:.3f}; {r['kernels']} kernel launches + {r['copies']} copies/sets, "
        f"{r['syncs']} host syncs; on {smi}")
    return r


def phase_vqa_veto(bridge: BLIP2VQA, rgb: torch.Tensor, smi: str) -> dict:
    b, h, w = rgb.shape[:3]
    k = VLFMConfig().max_detections_per_frame
    masks, _ = veto_slots(b, k, h, w, b * k)
    probe = make_veto(bridge, 0)
    images = probe.annotate(rgb, masks)
    dense_logits = first_logits(probe, images, COCO_TARGET)  # all B*K slots in one batch
    launches, fused = dict(layer_norm=0, attention=0), 0
    for density in VQA_DENSITIES:
        _, valid = veto_slots(b, k, h, w, density)
        flat_valid = valid.reshape(-1)
        yes = int(dense_logits[flat_valid].argmax(-1)[0])  # the first valid slot's answer: some keep, some drop
        gated = make_veto(bridge, yes, VQA_CAPACITY)
        reset_counters()
        out = gated(rgb, masks, valid, COCO_TARGET)
        torch.cuda.synchronize()
        passes = -(-density // VQA_CAPACITY)
        got = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"))
        for name in launches:
            launches[name] += got[name]
        log(f"[vqa] {density} valid slots of {b}x{k} at capacity {VQA_CAPACITY}: {passes} passes; K1 "
            f"{got['layer_norm']} (expect {passes * LAUNCHES_IMAGE}, {got['layer_norm'] / passes:.0f} per pass), K3 "
            f"{got['attention']} (expect {passes * ATTN_LAUNCHES_IMAGE}, {got['attention'] / passes:.0f} per pass)")
        check(got == dict(layer_norm=passes * LAUNCHES_IMAGE, attention=passes * ATTN_LAUNCHES_IMAGE),
              f"veto at {density} valid slots: K1 and K3 launch counts")
        fused += with_fused(got, "vqa", passes * FUSED_IMAGE)["layer_norm_fused"]
        # The gated passes' first-token logits (the same capacity-8 windows
        # of the valid-first order) against the dense batch's.
        order = torch.argsort((~flat_valid).to(torch.uint8), stable=True)[:passes * VQA_CAPACITY]
        gated_logits = torch.cat([first_logits(gated, images[order[i:i + VQA_CAPACITY]], COCO_TARGET)
                                  for i in range(0, len(order), VQA_CAPACITY)])
        sel = order[:density]
        err = float((gated_logits[:density] - dense_logits[sel]).abs().max())
        dense_prefix = probe.image_prefix(images)
        prefix_err = max(float((gated.image_prefix(images[order[i:i + VQA_CAPACITY]])
                                - dense_prefix[order[i:i + VQA_CAPACITY]]).abs().max())
                         for i in range(0, len(order), VQA_CAPACITY))
        log(f"[vqa] {density} valid slots: visual prefix in passes of {VQA_CAPACITY} against B={len(images)} "
            f"max_abs_err={prefix_err:.3e}; first-token logits: std {float(dense_logits.std()):.3f}, top-2 margins of "
            f"the valid slots {[round(float(m), 3) for m in top2_margin(dense_logits[sel])]}")
        ties = top2_margin(dense_logits[sel]) <= VQA_TIE
        dense_out = make_veto(bridge, yes)(rgb, masks, valid, COCO_TARGET)
        differ = (out.reshape(-1)[sel] != dense_out.reshape(-1)[sel])
        log(f"[vqa] {density} valid slots: gated against dense first-token logits max_abs_err={err:.3e} (tol "
            f"{VQA_LOGIT_ATOL}); near ties (top-2 margin <= {VQA_TIE}) {int(ties.sum())}; vetoes differ on "
            f"{int(differ.sum())} valid slots, all near ties: {bool((~differ | ties).all())}; yes = {yes}, kept "
            f"{int(out.sum())} of {density}; answers {gated_logits[:density].argmax(-1).tolist()}")
        check(err <= VQA_LOGIT_ATOL, f"veto at {density} valid slots: gated logits differ from dense")
        check(bool((~differ | ties).all()), f"veto at {density} valid slots: gated differs from dense off near ties")
        check(bool((out <= valid).all()), "the veto validated an invalid slot")
        timed(f"B={b} veto, {density} valid slots ({passes} passes of {VQA_CAPACITY}, {VQA_TOKENS} answer tokens)",
              lambda: gated(rgb, masks, valid, COCO_TARGET).cpu(), smi)
    return {**launches, "layer_norm_fused": fused}


class CountingVeto:
    """The pipeline's veto, recording each call's valid slots and frames
    with a detection before the veto (gated SAM's frames) as device
    tensors (no host read until the run ends)."""

    def __init__(self, veto):
        self.veto, self.valid, self.frames = veto, [], []

    def __call__(self, rgb, masks, valid, phrases, cls=None):
        self.valid.append(valid.sum())
        self.frames.append(valid.any(dim=1).sum())
        return self.veto(rgb, masks, valid, phrases, cls)

    def __getattr__(self, name):
        return getattr(self.veto, name)


def phase_vqa_full_stack(engine: PerceptionEngine, det, sam, bridge: BLIP2VQA, spec, smi: str) -> dict:
    b = BATCH_LANES
    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=SAM_CAPACITY, use_vqa=True,
                              vqa_slot_capacity=VQA_CAPACITY)
    env_cfg = EnvConfig()
    h, w = env_cfg.height, env_cfg.width
    pointnav = PointNavPolicy.init_random(seed=0, depth_shape=tuple(cfg.depth_image_shape), device=DEV)
    perception = FullStackPerception(cfg, itm=engine.itm, detector=det, sam=sam, blip2_vqa=bridge,
                                     det_threshold=cfg.non_coco_threshold, device=DEV)
    vetoes = perception.pipeline.vqa_veto = CountingVeto(perception.pipeline.vqa_veto)
    layout = full_stack_layout(b, h, w)
    packed = perception.make_fused_step(pointnav, spec, cfg, COCO_TARGET, layout=layout)
    unpacked = perception.make_fused_step(pointnav, spec, cfg, COCO_TARGET)
    buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
    views = packing.pack_views(buf.numpy(), layout)
    envs = [FakeObjectNavEnv(two_room_plan(seed=lane), env_cfg) for lane in range(b)]
    obs_list = [e.reset() for e in envs]
    perception.engine.text_features(COCO_TARGET)
    perception.pipeline._queries(COCO_TARGET)
    perception.pipeline.coco_detector._coco_queries()
    perception.pipeline.vqa_veto._question_tokens(COCO_TARGET)
    state = ITM.create_state(spec, cfg, batch=b, device=DEV)
    record = []
    reset_counters()
    t0 = time.perf_counter()
    for k in range(VQA_STEPS):
        for j, o in enumerate(obs_list):
            views["depth"][j], views["rgb"][j] = o["depth"], o["rgb"]
            views["heading"][j], views["xy"][j] = o["heading"], o["robot_xy"]
        views["seeds"][:], views["steps"][:], views["reset"][:] = np.arange(b), k, 0
        inputs = {name: v.copy() for name, v in views.items()}
        out, state = packed(state, None, buf)
        out_np = out.cpu().numpy()
        record.append(dict(inputs=inputs, out=out))
        for i, env in enumerate(envs):
            if not obs_list[i]["done"]:
                obs_list[i] = env.step(int(out_np[i, 0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"),
                    mbconv_chain=counted("K2.launches"))
    frames = [int(f) for f in vetoes.frames]
    n_valid = [int(v) for v in vetoes.valid]
    sam_passes = sum(-(-f // SAM_CAPACITY) for f in frames)
    veto_passes = [-(-n // VQA_CAPACITY) for n in n_valid]
    ln_step = LAUNCHES_IMAGE + 2 * LAUNCHES_DETECT
    want = dict(layer_norm=VQA_STEPS * ln_step + LAUNCHES_IMAGE * sum(veto_passes),
                attention=ATTN_LAUNCHES_IMAGE * (VQA_STEPS + sum(veto_passes)),
                mbconv_chain=chain_launches(sam.cfg.tinyvit) * sam_passes)
    kept = np.stack([r["out"][:, 1].cpu().numpy() for r in record]).sum(axis=1).astype(int).tolist()
    log(f"[vqa-stack] {b} lanes of two_room_plan at {w}x{h}, {VQA_STEPS} fused dispatches with the veto (BLIP-2 "
        f"flan-T5-XL at capacity {VQA_CAPACITY}, {VQA_TOKENS} answer tokens): {wall:.2f} s incl. first calls; valid "
        f"slots asked per dispatch {n_valid}, veto passes {veto_passes}; lanes with target_detected per step {kept}; "
        f"K1 {launches['layer_norm']} (expect {want['layer_norm']}), K3 {launches['attention']} (expect "
        f"{want['attention']}), K2 {launches['mbconv_chain']} (expect {want['mbconv_chain']})")
    check(launches == want, "full stack with the veto: K1, K3 and K2 launch counts")
    launches = with_fused(launches, "vqa-stack", VQA_STEPS * FUSED_STEP + FUSED_IMAGE * sum(veto_passes))
    check(sum(veto_passes) > 0, "the full stack's veto asked no slot")
    st = ITM.create_state(spec, cfg, batch=b, device=DEV)
    names = ("reset", "depth", "heading", "xy", "rgb", "seeds", "steps")
    for k, r in enumerate(record):
        action, det_flag, goal, st = unpacked(st, None, *(r["inputs"][n] for n in names))
        got = torch.cat([action[:, None].float(), det_flag[:, None].float(), goal], dim=1)
        check(torch.equal(got, r["out"]), f"veto full stack step {k}: unpacked outputs differ from packed")
    log(f"[vqa-stack] the unpacked signature gives every lane's actions, detected flags and goals bit for bit over "
        f"the {VQA_STEPS} steps")

    # One dispatch with the veto beside one without it, on the last inputs.
    plain_cfg = dataclasses.replace(cfg, use_vqa=False)
    plain = FullStackPerception(plain_cfg, itm=engine.itm, detector=det, sam=sam,
                                det_threshold=cfg.non_coco_threshold, device=DEV)
    plain_step = plain.make_fused_step(pointnav, spec, plain_cfg, COCO_TARGET, layout=layout)
    st = state._replace(steps=state.steps + 1)
    rows = {}
    for label, fused in (("without the veto", plain_step), ("with the veto", packed)):
        rows[label] = step_timings(f"fused dispatch {label}", b, lambda: fused(st, None, buf)[0].cpu(), smi)
    log(f"[vqa-stack-time] B={b}: the veto's dispatch takes {rows['with the veto']['ms'] / rows['without the veto']['ms']:.2f}x "
        f"the wall time and {rows['with the veto']['device_ms'] / rows['without the veto']['device_ms']:.2f}x the device "
        f"time of the dispatch without it; on {smi}")

    seeds = list(range(VQA_FARM_EPISODES))
    farm, fstats = run_episodes_farm(seeds, lanes=b, pointnav="greedy", spec=spec, cfg=cfg,
                                     plan_name="open_room_plan", env_cfg=env_cfg, workers=FARM_WORKERS,
                                     max_steps=VQA_FARM_STEPS, perception=perception, target=COCO_TARGET)
    check(set(farm) == set(seeds) and all(r.steps > 0 for r in farm.values()), "the veto's farm lost an episode")
    res = [farm[s] for s in seeds]
    log(f"[vqa-farm] the full stack with the veto in run_episodes_farm: {VQA_FARM_EPISODES} open_room_plan episodes "
        f"(at most {VQA_FARM_STEPS} steps) on {b} lanes, all finished, steps {[r.steps for r in res]}, detected "
        f"{sum(r.target_detected for r in res)}; {farm_summary(fstats)}; on {smi}")
    return launches


# --- phase 22 ----------------------------------------------------------------
def phase_tiny_zoedepth() -> None:
    for name, cfg in (("NYU", ZoeDepthConfig.tiny_test()),
                      ("NK", dataclasses.replace(ZoeDepthConfig.tiny_test(),
                                                 bin_configurations=ZoeDepthConfig.nk().bin_configurations))):
        cpu = ZoeDepth.init_random(cfg, seed=0, device="cpu")
        gpu = ZoeDepth(cfg, copy.deepcopy(cpu.module).to(DEV))
        px = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32))
        want = cpu.predict(px)
        got = gpu.predict(px.to(DEV)).cpu()
        err = float((got - want).abs().max())
        rgb = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8))
        inf_err = float((gpu.infer_depth(rgb.to(DEV), 0.5, 5.0).cpu() - cpu.infer_depth(rgb, 0.5, 5.0)).abs().max())
        log(f"[tiny-zoe] {name}: card vs CPU metric depth max_abs_err={err:.3e} m, infer_depth {inf_err:.3e} "
            f"(tol {TINY_ZOE_ATOL}); depth in [{float(want.min()):.3f}, {float(want.max()):.3f}] m")
        check(err <= TINY_ZOE_ATOL and inf_err <= TINY_ZOE_ATOL, f"tiny ZoeDepth {name}: card differs from CPU")


def phase_zoedepth(engine: PerceptionEngine, det, sam, rgb: torch.Tensor, smi: str) -> ZoeDepth:
    zoe = ZoeDepth.init_random(ZoeDepthConfig.nk(), seed=0, device=DEV)
    cast_for_serving(zoe.module)
    n_params = sum(p.numel() for p in zoe.module.parameters())
    cam = VLFMConfig().camera
    b = rgb.shape[0]
    t0 = time.perf_counter()
    depth = zoe.infer_depth(rgb, cam.min_depth, cam.max_depth)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    check(depth.shape == rgb.shape[:3] and depth.dtype == torch.float32, "ZoeD_NK depth shape")
    check(bool(torch.isfinite(depth).all() and (depth >= 0).all() and (depth <= 1).all()), "ZoeD_NK depth in [0, 1]")
    worst = max(float((zoe.infer_depth(rgb[i:i + 1], cam.min_depth, cam.max_depth) - depth[i:i + 1]).abs().max())
                for i in range(b))
    log(f"[zoe] ZoeD_NK (BEiT-L/16 at 384 px, DPT, two metric heads and the router; {n_params / 1e6:.1f} M "
        f"parameters, bf16 weights, f32 stream) on the {b} spin frames at {rgb.shape[2]}x{rgb.shape[1]}: "
        f"{first:.2f} s incl. first call; depth in [{float(depth.min()):.4f}, {float(depth.max()):.4f}], mean "
        f"{float(depth.mean()):.4f}; each lane against its B=1 run max_abs_err={worst:.3e} (tol {ZOE_LANE_ATOL})")
    check(worst <= ZOE_LANE_ATOL, "ZoeD_NK: a lane at B=8 differs from its B=1 run")
    for lanes in (1, b):
        def infer():
            zoe.infer_depth(rgb[:lanes], cam.min_depth, cam.max_depth)

        kernels, copies, busy, wall = launch_profile(infer)
        ms = wall_ms(infer, reps=5, warmup=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            infer()
            torch.cuda.synchronize()
        by_name = {}
        for e in device_events(prof):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
        log(f"[zoe-time] B={lanes} infer_depth: {ms:.2f} ms wall (median of 5), {ms / lanes:.2f} ms per frame; under "
            f"the profiler {busy:.2f} ms of device time, idle share {1 - busy / wall:.3f}, {kernels} kernel launches "
            f"+ {copies} copies/sets; most launched: "
            f"{'; '.join(f'{name[:70]} x{n} {us / 1e3:.2f} ms' for name, (n, us) in top)}; on {smi}")

    # The fallback: all-ones depth infers, sensor depth comes back unchanged.
    perception = FullStackPerception(VLFMConfig(), itm=engine.itm, detector=det, sam=sam, monodepth=zoe,
                                     det_threshold=0.0, device=DEV)
    frame = rgb[0].cpu().numpy()
    ones = np.ones(frame.shape[:2], np.float32)
    _, _, valid, inferred = perception(frame, OPEN_TARGET, ones)
    check(bool(valid.any()), "the fallback's frame needs a valid detection")
    check(inferred is not ones and inferred.shape == ones.shape and not np.all(inferred == 1.0),
          "all-ones depth was not inferred")
    direct = zoe.infer_depth(rgb[:1], cam.min_depth, cam.max_depth)[0].cpu().numpy()
    check(np.abs(inferred - direct).max() <= ZOE_LANE_ATOL, "the fallback's depth differs from ZoeD_NK's on the frame")
    sensor = spin_views(1)[0]["depth"]
    check(perception(frame, OPEN_TARGET, sensor)[3] is sensor, "sensor depth did not come back unchanged")
    log(f"[zoe] FullStackPerception with all-ones depth and {int(valid.sum())} valid detections: depth inferred "
        f"(mean {float(inferred.mean()):.4f}, equal to infer_depth on the frame); with the sensor's depth the same "
        f"object comes back")
    return zoe


# --- phase 23 ----------------------------------------------------------------
def phase_bc_tiny() -> None:
    """One BC batch (B=2, T=6, 48x64 depth) through ``bc_loss_fn`` and its
    backward on the CPU and on the card, from the same weights."""
    data = IM.collect_pointnav_rollouts(2, seed=3, env_cfg=EnvConfig(width=64, height=48, max_steps=30),
                                        depth_shape=BC_TINY_SHAPE, max_steps=6, device="cpu")
    cpu = PointNavPolicy.init_random(0, depth_shape=BC_TINY_SHAPE, device="cpu")
    gpu = PointNavPolicy(copy.deepcopy(cpu.module).to(DEV))
    out = []
    for policy, dev in ((cpu, torch.device("cpu")), (gpu, DEV)):
        batch = [torch.from_numpy(data[k]).to(dev) for k in ("depth", "goal", "action", "valid")]
        with exact_f32(dev):
            loss, acc = IM.bc_loss_fn(policy, *batch)
            loss.backward()
        out.append((float(loss.detach()), float(acc),
                    {n: p.grad.cpu() for n, p in policy.module.named_parameters()}))
    (lc, ac, gc), (lg, ag, gg) = out
    worst, name_worst = 0.0, ""
    for name, want in gc.items():
        scale = float(want.abs().max())
        err = float((gg[name] - want).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, name_worst = err, name
        check(torch.allclose(gg[name], want, rtol=BC_GRAD_RTOL, atol=BC_GRAD_ATOL * scale),
              f"BC gradient {name}: card differs from CPU")
    log(f"[bc-tiny] bc_loss_fn, B=2 T=6 at {BC_TINY_SHAPE[1]}x{BC_TINY_SHAPE[0]}, valid {int(data['valid'].sum())} of "
        f"12: loss card {lg:.7f} CPU {lc:.7f} (rel err {abs(lg - lc) / abs(lc):.2e}, tol {BC_LOSS_RTOL}), accuracy "
        f"{ag} and {ac}; {len(gc)} gradients, worst max_abs_err / largest entry {worst:.2e} ({name_worst}; tol "
        f"rtol {BC_GRAD_RTOL} + {BC_GRAD_ATOL} of the largest)")
    check(abs(lg - lc) <= BC_LOSS_RTOL * abs(lc) and ag == ac, "BC loss or accuracy: card differs from CPU")


def phase_bc(spec, smi: str):
    """Fit the full-width PointNav to the greedy controller on the card,
    then run the JAX bench's trained farm with it beside the greedy one.
    Returns the fitted policy."""
    cfg = VLFMConfig()
    shape = tuple(cfg.depth_image_shape)
    env_cfg = EnvConfig(max_steps=BC_ENV_STEPS)
    rollout_kw = dict(seed=BC_FIT["seed"], env_cfg=env_cfg, depth_shape=shape, max_steps=BC_FIT["max_steps"],
                      transport=BC_FIT["transport"], device=DEV)
    t0 = time.perf_counter()
    data = IM.collect_pointnav_rollouts(BC_FIT["episodes"], **rollout_kw)
    rollout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    policy, bc = IM.fit_pointnav_to_greedy(depth_shape=shape, env_cfg=env_cfg, device=DEV, **BC_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # Device time per Adam step: a copy of the fitted network takes
    # BC_TIMED_STEPS more steps on the same rollouts under the profiler.
    probe = PointNavPolicy(copy.deepcopy(policy.module))
    IM.train_pointnav_bc(probe, data, steps=1, batch=BC_FIT["batch"])  # the optimiser's first-call allocations
    kernels, copies, busy, wall = launch_profile(
        lambda: IM.train_pointnav_bc(probe, data, steps=BC_TIMED_STEPS, batch=BC_FIT["batch"]))
    frames = int(data["valid"].sum())
    log(f"[bc] fit_pointnav_to_greedy at the JAX bench's setting: {BC_FIT['episodes']} open_room_plan episodes "
        f"(EnvConfig max_steps {BC_ENV_STEPS}, at most {BC_FIT['max_steps']} steps, {frames} frames, u16 half-size "
        f"depth seam on the card), {BC_FIT['train_steps']} Adam steps at batch {BC_FIT['batch']} on {shape[0]}x"
        f"{shape[1]} depth: rollouts {rollout_s:.2f} s (collected alone), the fit {fit_s:.2f} s with its rollouts "
        f"(training {fit_s - rollout_s:.2f} s); an Adam step {busy / BC_TIMED_STEPS:.2f} ms of device time, "
        f"{wall / BC_TIMED_STEPS:.2f} ms wall, idle share {1 - busy / wall:.3f}, {kernels // BC_TIMED_STEPS} kernel "
        f"launches + {copies // BC_TIMED_STEPS} copies/sets (profiler, {BC_TIMED_STEPS} steps); teacher accuracy "
        f"{bc['accuracy']:.4f}, loss {bc['loss']:.4f} (the last minibatch); on {smi}")
    check(bc["accuracy"] > BC_ACCURACY, f"BC accuracy {bc['accuracy']:.3f} is not above {BC_ACCURACY}")

    farm_kw = dict(lanes=TRAINED_LANES, spec=spec, cfg=cfg, plan_name="open_room_plan",
                   env_cfg=EnvConfig(max_steps=TRAINED_ENV_STEPS), workers=FARM_WORKERS, depth_u16=True,
                   depth_half=True, device=DEV)
    rows = {}
    for label, pointnav in (("the fitted PointNav", policy), ("the greedy controller", "greedy")):
        res, stats = run_episodes_farm(TRAINED_SEEDS, pointnav=pointnav, **farm_kw)
        check(set(res) == set(TRAINED_SEEDS), f"the farm with {label} lost an episode")
        rate = sum(r.success for r in res.values()) / len(res)
        rows[label] = rate
        log(f"[bc-farm] run_episodes_farm with {label} producing every PointNav action: {len(res)} open_room_plan "
            f"episodes (seeds {TRAINED_SEEDS[0]}-{TRAINED_SEEDS[-1]}, at most {TRAINED_ENV_STEPS} steps) on "
            f"{TRAINED_LANES} lanes, {FARM_WORKERS} workers, u16 half-size depth, oracle perception: success rate "
            f"{rate:.4f}, steps {[res[s].steps for s in TRAINED_SEEDS]}; {farm_summary(stats)}; on {smi}")
    check(rows["the fitted PointNav"] > 0, "no episode succeeded through the fitted PointNav")
    return policy


# --- phase 24 ----------------------------------------------------------------
class CountingAgent:
    """A ``HabitatVLFMAgent`` whose every ``act`` records its wall time and
    the K1, K2 and K3 launches it made (the counts' difference across it)."""

    def __init__(self, agent):
        self.agent, self.acts = agent, []

    def act(self, obs):
        before = (counted("K1.launches"), counted("K2.launches"), counted("K3.launches"))
        t0 = time.perf_counter()
        action = self.agent.act(obs)  # ends in a read of the action
        ms = (time.perf_counter() - t0) * 1e3
        after = (counted("K1.launches"), counted("K2.launches"), counted("K3.launches"))
        self.acts.append((ms, *(a - b for a, b in zip(after, before))))
        self.last_obs = obs
        return action

    def __getattr__(self, name):
        return getattr(self.agent, name)


def cli_json(args: list) -> dict:
    """Run ``python -m ...`` from the checkout's root; it must exit 0 and
    end its output with a JSON object."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(out.returncode == 0, f"python -m {' '.join(args)} exited {out.returncode}: {out.stderr[-2000:]}")
    text = out.stdout
    start = text.index("\n{") + 1 if not text.startswith("{") else 0
    lines = text[:start].strip().splitlines()
    log(f"[cli] python -m {' '.join(args)}: exit 0 in {time.perf_counter() - t0:.2f} s; "
        f"{lines[-1] if lines else ''}")
    return json.loads(text[start:])


def phase_habitat_eval(engine: PerceptionEngine, det, sam, pointnav, smi: str) -> dict:
    """``habitat_eval.evaluate`` over ``FakeHabitatEnv`` with the full stack
    at full width, one lane (B=1) per act, logs and videos; then the two
    command-line entry points."""
    import cv2

    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=SAM_CAPACITY)
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    env_cfg = EnvConfig(max_steps=HABITAT_STEPS)
    perception = FullStackPerception(cfg, itm=engine.itm, detector=det, sam=sam,
                                     det_threshold=cfg.non_coco_threshold, device=DEV)
    counter = perception.pipeline = CountingPipeline(perception.pipeline)
    agent = CountingAgent(HabitatVLFMAgent(cfg, spec, pointnav, perception, version="v2", device=DEV))
    perception.engine.text_features(HABITAT_TARGET)  # cached before the counts
    perception.pipeline._queries(HABITAT_TARGET)
    perception.pipeline.coco_detector._coco_queries()

    def factory(i):
        return FakeHabitatEnv(FakeObjectNavEnv(two_room_plan(seed=i), env_cfg), episode_id=str(i),
                              scene_id="two_room", object_category=HABITAT_TARGET)

    with tempfile.TemporaryDirectory() as tmp:
        log_dir, video_dir = os.path.join(tmp, "logs"), os.path.join(tmp, "videos")
        reset_counters()
        t0 = time.perf_counter()
        results = evaluate(factory, agent, HABITAT_EPISODES, log_dir=log_dir, video_dir=video_dir, print_fn=log)
        wall = time.perf_counter() - t0
        launches = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"),
                        mbconv_chain=counted("K2.launches"))
        logged = load_logs(log_dir)
        videos = sorted(os.listdir(video_dir))
        frames = []
        for name in videos:
            cap = cv2.VideoCapture(os.path.join(video_dir, name))
            frames.append(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
            cap.release()
    check(len(results) == HABITAT_EPISODES and all(r.steps > 0 for r in results), "evaluate lost an episode")
    steps = [r.steps for r in results]
    acts = np.array(agent.acts)
    check(len(acts) == sum(steps), "one act per env step")
    passes = [-(-int(f) // SAM_CAPACITY) for f in counter.frames]
    want_k1, want_k3 = LAUNCHES_IMAGE + 2 * LAUNCHES_DETECT, ATTN_LAUNCHES_IMAGE
    want_k2 = [chain_launches(sam.cfg.tinyvit) * p for p in passes]
    check(acts[:, 1].tolist() == [want_k1] * len(acts) and acts[:, 3].tolist() == [want_k3] * len(acts)
          and acts[:, 2].tolist() == want_k2, "K1, K2 or K3 launches per act")
    check(launches == dict(layer_norm=int(acts[:, 1].sum()), mbconv_chain=int(acts[:, 2].sum()),
                           attention=int(acts[:, 3].sum())), "launch counts over the run")
    launches = with_fused(launches, "habitat", len(acts) * FUSED_STEP)
    # The logs' summary equals the same summary of the returned results,
    # and its aggregates metrics.aggregate's.
    want = summarize([{**r.to_dict(), "target_object": HABITAT_TARGET} for r in results])
    got = summarize(logged)
    agg = RM.aggregate(results)
    check(got == want and all(got[k] == agg[k] for k in ("episodes", "success_rate", "spl", "soft_spl",
                                                         "failure_causes")),
          f"analyze_logs' summary {got} differs from the results' {want} / {agg}")
    # One frame per step, but the last: the one-step-delay realignment drops it.
    check(frames == [n - 1 for n in steps], f"video frames {frames} for episodes of {steps} steps")
    per_act = float(np.median(acts[1:, 0]))
    log(f"[habitat] evaluate over FakeHabitatEnv: {HABITAT_EPISODES} two_room_plan episodes at "
        f"{env_cfg.width}x{env_cfg.height} (at most {HABITAT_STEPS} steps) through HabitatVLFMAgent (v2, the fitted "
        f"PointNav; FullStackPerception: BLIP2-ITM, OWL-ViT with the COCO route, MobileSAM gated at {SAM_CAPACITY}) "
        f"with logs and videos: {wall:.2f} s incl. first calls; steps {steps}, successes "
        f"{sum(r.success for r in results)}, causes {[r.failure_cause for r in results]}; per act K1 {want_k1}, "
        f"K3 {want_k3}, K2 {sorted(set(want_k2))} (SAM passes {sum(passes)} of {len(acts)} acts); K1 "
        f"{launches['layer_norm']}, K2 {launches['mbconv_chain']}, K3 {launches['attention']} over the run; "
        f"analyze_logs' summary equals the results'; videos {frames} frames; an act {per_act:.2f} ms wall (median "
        f"of acts 2-{len(acts)}, the env's step and the maps' renders outside it)")
    # One act at B=1 under the profiler, and its host syncs, on the last observation.
    obs = agent.last_obs
    kernels, copies, busy, pwall = launch_profile(lambda: agent.agent.act(obs))
    ms = wall_ms(lambda: agent.agent.act(obs), reps=5, warmup=1)
    syncs = host_syncs(lambda: agent.agent.act(obs))
    log(f"[habitat-time] B=1 HabitatVLFMAgent.act: {ms:.2f} ms wall (median of 5), {1e3 / ms:.1f} env-steps/s; under "
        f"the profiler {busy:.2f} ms of device time, idle share {1 - busy / pwall:.3f}; {kernels} kernel launches + "
        f"{copies} copies/sets, {syncs} host syncs; on {smi}")

    run_out = cli_json(["vlfm_tpu_torch.run", "--backend", "synthetic", "--episodes", "2", "--max-steps",
                        str(HABITAT_STEPS)])
    check(run_out["episodes"] == 2 and run_out["avg_steps"] > 0, f"run.py's aggregate {run_out}")
    demo_out = cli_json(["vlfm_tpu_torch.runner.demo", "--episodes", "1"])
    check(demo_out["episodes"] == 1 and demo_out["avg_steps"] > 0, f"the demo's aggregate {demo_out}")
    log(f"[cli] run.py (synthetic, 2 episodes of at most {HABITAT_STEPS} steps): {json.dumps(run_out)}; the demo (1 episode): "
        f"{json.dumps(demo_out)}; on {smi}")
    return launches


# --- phase 25 ----------------------------------------------------------------
class RealityHooks:
    """``RealityITMPolicyV2``'s perception hooks as closures over the full
    stack and ZoeD_NK: ``score`` (the ITM cosines), ``detect`` (the
    target's masks and validity) and ``infer_depth`` (counted). With
    ``replay`` set to a step's recorded outputs they return those; with
    ``blind`` every detection is dropped (a step without one)."""

    def __init__(self, perception: FullStackPerception, zoe: ZoeDepth, target: str):
        self.perception, self.zoe, self.target = perception, zoe, target
        self.depth_calls, self.blind, self.replay = 0, False, None

    @staticmethod
    def _frame(rgb: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rgb).to(DEV)[None]

    def score(self, rgb):
        if self.replay is not None:
            return self.replay["cos"]
        return self.perception.engine.score(self._frame(rgb), self.target)[0]

    def detect(self, rgb):
        if self.replay is not None:
            return self.replay["masks"], self.replay["valid"]
        masks, valid, _ = self.perception.pipeline(self._frame(rgb), self.target)
        return masks[0], torch.zeros_like(valid[0]) if self.blind else valid[0]

    def infer_depth(self, rgb, min_depth, max_depth):
        self.depth_calls += 1
        if self.replay is not None:
            return self.replay["depth"]
        return self.zoe.infer_depth(self._frame(rgb), min_depth, max_depth)[0]

    def fns(self) -> dict:
        return dict(score_fn=self.score, detect_fn=self.detect, infer_depth_fn=self.infer_depth)


def clone_tree(tree):
    return map_tensors(lambda t: t.clone(), tree)


def tree_diff(a, b) -> tuple[bool, float]:
    """(bit-equal, largest absolute difference) of two trees of tensors of
    the same structure."""
    fa, fb = [], []
    map_tensors(fa.append, a)
    map_tensors(fb.append, b)
    equal = len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))
    worst = max(float((x.double() - y.double()).abs().max()) for x, y in zip(fa, fb) if x.numel())
    return equal, worst


def reality_replay(step: dict, cpu_pointnav, spec, cfg) -> dict:
    """The card's step re-run on the CPU (plain versions) from the card's
    state before it and the same inputs; each quantity against the card's."""
    cpu = lambda tree: map_tensors(lambda t: t.cpu(), tree)  # noqa: E731
    act, st = REAL.reality_step(cpu(step["before"]), *cpu(step["inputs"]), pointnav=cpu_pointnav, spec=spec,
                                cfg=cfg, version="v2")
    got, card = cpu(step["after"]), step["action"]
    flips = {n: int((getattr(got.obstacle, n) != getattr(st.obstacle, n)).sum())
             for n in ("obstacles", "navigable", "explored")}
    fr_atol = REALITY_FRONTIER_ATOL_M if not any(flips.values()) else FRONTIER_ATOL_M
    value_far = max(int(((getattr(got.value, n) - getattr(st.value, n)).abs() > REALITY_VALUE_ATOL)
                        .reshape(*got.value.conf.shape, -1).any(-1).sum()) for n in ("conf", "values"))
    exact = ("point_valid", "slot_used", "point_in_range", "cursor", "has_last_target")
    r = dict(
        flips=flips,
        frontiers_valid=torch.equal(got.obstacle.frontiers_valid, st.obstacle.frontiers_valid),
        frontier_err=float((got.obstacle.frontiers_xy - st.obstacle.frontiers_xy).abs().max()),
        frontier_atol=fr_atol,
        value_far=value_far,
        value_err=float((got.value.values - st.value.values).abs().max()),
        objmap_exact=all(torch.equal(getattr(got.objmap, n), getattr(st.objmap, n)) for n in exact),
        point_err=max(float((getattr(got.objmap, n) - getattr(st.objmap, n)).abs().max())
                      for n in ("points", "last_target")),
        action_err=max(abs(card[n] - float(getattr(act, n)[0])) for n in ("angular", "linear")),
        rho_theta_err=max(abs(c - float(t[0])) for c, t in zip(card["rho_theta"], (act.rho, act.theta))),
        exact_flags=card["arm_yaw"] == float(act.arm_yaw[0]) and card["stop"] == bool(act.stop[0]),
        pointnav_err=max(float((getattr(got.pointnav, n) - getattr(st.pointnav, n)).abs().max())
                         for n in ("h", "c", "prev_action")),
    )
    r["ok"] = (all(f <= MAP_FLIPS * REALITY_CELLS for f in flips.values()) and r["frontiers_valid"]
               and r["frontier_err"] <= fr_atol and r["value_far"] <= MAP_FLIPS * 256 * 256
               and r["objmap_exact"] and r["point_err"] <= OBJ_POINT_ATOL
               and max(r["action_err"], r["rho_theta_err"]) <= REALITY_ACTION_ATOL and r["exact_flags"])
    return r


def reality_timing(label: str, fn, sync_on: torch.Tensor, smi: str) -> dict:
    """Wall ms (``StepTimer``, median of REALITY_TIMED), device ms, idle
    share and launches (torch.profiler, one call) and host syncs of ``fn``."""
    timer = StepTimer()
    for _ in range(REALITY_TIMED):
        with timer.section(label, sync_on=sync_on):
            fn()
    kernels, copies, busy, wall = launch_profile(fn)
    r = dict(ms=timer.summary()[label]["p50_ms"], device_ms=busy, idle=1 - busy / wall, kernels=kernels,
             copies=copies, syncs=host_syncs(fn))
    log(f"[reality-time] B=1 {label}: {r['ms']:.2f} ms wall (median of {REALITY_TIMED}); under the profiler "
        f"{r['device_ms']:.2f} ms of device time, idle share {r['idle']:.3f}; {r['kernels']} kernel launches + "
        f"{r['copies']} copies/sets, {r['syncs']} host syncs; on {smi}")
    return r


def phase_reality(engine: PerceptionEngine, det, sam, zoe: ZoeDepth, smi: str) -> dict:
    """FakeRobot -> ObjectNavEnv -> RealityITMPolicyV2 at B=1 and full
    width: 24 actions with the full stack's hooks and ZoeD_NK, each step
    replayed on the CPU, a checkpoint after step 12 resumed, the value-map
    updates recorded and replayed, and one get_action timed by part."""
    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=SAM_CAPACITY)
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    perception = FullStackPerception(cfg, itm=engine.itm, detector=det, sam=sam,
                                     det_threshold=cfg.non_coco_threshold, device=DEV)
    hooks = RealityHooks(perception, zoe, REALITY_TARGET)
    pointnav = PointNavPolicy.init_random(0, depth_shape=tuple(cfg.depth_image_shape), discrete=False, device=DEV)
    policy = REAL.RealityITMPolicyV2(spec, cfg, pointnav=pointnav, version="v2", seed=0, device=DEV, **hooks.fns())
    env = ObjectNavEnv(FakeRobot(seed=0), RealityEnvConfig(all_cams_until_step=10))
    perception.engine.text_features(REALITY_TARGET)  # cached before the counts
    perception.pipeline._queries(REALITY_TARGET)
    perception.pipeline.coco_detector._coco_queries()

    with tempfile.TemporaryDirectory() as tmp:
        rec_dir, ckpt = os.path.join(tmp, "value_map"), os.path.join(tmp, "robot.pt")
        recorder = VIO.ValueMapRecorder(rec_dir, kwargs={"value_channels": cfg.value_channels})
        steps, episodes, ep_step = [], 1, 0
        obs = env.reset(REALITY_TARGET)
        timer = StepTimer()
        reset_counters()
        t0 = time.perf_counter()
        for k in range(REALITY_ACTIONS):
            before, calls = clone_tree(policy.state), hooks.depth_calls
            with timer.section("get_action"):  # ends in the action's read back
                action = policy.get_action(obs)
            body, hand, cos, value_depth = policy.last_inputs[:4]
            recorder.record(cos[0], value_depth[0], hand.tf[0], 0.0, hand.max_depth, hand.fov)
            steps.append(dict(obs=obs, before=before, inputs=policy.last_inputs, action=action, ep_step=ep_step,
                              inferred=hooks.depth_calls - calls, after=clone_tree(policy.state)))
            if k + 1 == REALITY_CKPT_AFTER:
                save_pytree(ckpt, {"state": policy.state, "rng": policy.rng})
            if action["stop"]:
                obs, ep_step, episodes = env.reset(REALITY_TARGET), 0, episodes + 1
                policy.reset()
            else:
                obs, ep_step = env.step(action), ep_step + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = with_fused(dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"),
                                   mbconv_chain=counted("K2.launches")), "reality")
        detected = [bool(s["inputs"][6].any()) for s in steps]
        xy, yaw = env.robot.xy_yaw
        log(f"[reality] FakeRobot(seed=0) -> ObjectNavEnv -> RealityITMPolicyV2 (v2, B=1, continuous PointNav at "
            f"224x224, BLIP2-ITM, OWL-ViT with the COCO route ({REALITY_TARGET}), MobileSAM gated at {SAM_CAPACITY}, "
            f"ZoeD_NK; {spec.size}+2x{spec.pad} px maps): {REALITY_ACTIONS} actions in {wall:.2f} s incl. first "
            f"calls, {episodes} episode(s); steps with a detection {sum(detected)}, ZoeD_NK calls "
            f"{sum(s['inferred'] for s in steps)}; stops {sum(s['action']['stop'] for s in steps)}; robot at "
            f"({xy[0]:.3f}, {xy[1]:.3f}) m, yaw {yaw:.3f}; K1 {launches['layer_norm']}, K2 "
            f"{launches['mbconv_chain']}, K3 {launches['attention']}; get_action "
            f"{timer.summary()['get_action']['p50_ms']:.2f} ms wall (median of {REALITY_ACTIONS}, incl. first) on {smi}")
        for s, det_any in zip(steps, detected):
            a, j = s["action"], s["ep_step"]
            check(all(np.isfinite([a["angular"], a["linear"], a["arm_yaw"], *a["rho_theta"]])), f"action {a} not finite")
            if j < REAL.NUM_INIT_YAWS:
                check(a["arm_yaw"] == float(REAL.INITIAL_ARM_YAWS[j]) and a["angular"] == a["linear"] == 0.0,
                      f"start step {j}: {a} is not arm yaw {REAL.INITIAL_ARM_YAWS[j]} with the base still")
            else:
                check(a["arm_yaw"] == -1.0, f"step {j} after the start moved the arm: {a}")
            check(s["inferred"] == int(det_any), f"ZoeD_NK ran {s['inferred']} times on a step with detection "
                  f"{det_any}")
        check(all(v > 0 for v in launches.values()), f"the robot path launched no K1, K2 or K3: {launches}")

        # Each step again on the CPU, from the card's state before it.
        cpu_pointnav = PointNavPolicy(copy.deepcopy(pointnav.module).cpu())
        t1 = time.perf_counter()
        replays = [reality_replay(s, cpu_pointnav, spec, cfg) for s in steps]
        worst = {key: max(r[key] for r in replays) for key in ("frontier_err", "value_far", "value_err", "point_err",
                                                             "action_err", "rho_theta_err", "pointnav_err")}
        flips = {n: max(r["flips"][n] for r in replays) for n in ("obstacles", "navigable", "explored")}
        log(f"[reality] each step replayed on the CPU from the card's state ({time.perf_counter() - t1:.2f} s): "
            f"grid flips per step at most {flips} (tol {MAP_FLIPS} of {REALITY_CELLS} cells); frontier validity "
            f"equal on {sum(r['frontiers_valid'] for r in replays)}/{len(replays)}, positions within "
            f"{worst['frontier_err']:.3e} m (tol {REALITY_FRONTIER_ATOL_M} on steps with equal grids, "
            f"{sum(r['frontier_atol'] == REALITY_FRONTIER_ATOL_M for r in replays)} of them, else {FRONTIER_ATOL_M}); "
            f"value map max err {worst['value_err']:.3e}, cells beyond {REALITY_VALUE_ATOL} at most "
            f"{worst['value_far']} (tol {MAP_FLIPS} of 256x256); object map flags equal on "
            f"{sum(r['objmap_exact'] for r in replays)}/{len(replays)}, points within {worst['point_err']:.3e} m "
            f"(tol {OBJ_POINT_ATOL}); angular/linear within {worst['action_err']:.3e}, rho/theta "
            f"{worst['rho_theta_err']:.3e} (tol {REALITY_ACTION_ATOL}); arm_yaw and stop equal on "
            f"{sum(r['exact_flags'] for r in replays)}/{len(replays)}; PointNav h/c/prev_action within "
            f"{worst['pointnav_err']:.3e}")
        for k, r in enumerate(replays):
            check(r["ok"], f"reality step {k}: the CPU replay differs from the card: {r}")

        # The checkpoint after step 12, restored into a fresh policy fed the
        # recorded hook outputs for the remaining steps.
        replay_hooks = RealityHooks(perception, zoe, REALITY_TARGET)
        resumed = REAL.RealityITMPolicyV2(spec, cfg, pointnav=pointnav, version="v2", seed=0, device=DEV,
                                          **replay_hooks.fns())
        got = restore_pytree(ckpt, {"state": resumed.state, "rng": resumed.rng})
        same_state, _ = tree_diff(got["state"], steps[REALITY_CKPT_AFTER - 1]["after"])
        check(same_state, "the restored state differs from the saved one")
        resumed.state, resumed.rng = got["state"], got["rng"]
        act_err, bit_equal_actions = 0.0, True
        for s in steps[REALITY_CKPT_AFTER:]:
            if s["ep_step"] == 0:
                resumed.reset()
            inp = s["inputs"]
            replay_hooks.replay = dict(cos=inp[2][0], masks=inp[5][0], valid=inp[6][0], depth=inp[4][0])
            a = resumed.get_action(s["obs"])
            bit_equal_actions &= a == s["action"]
            act_err = max(act_err, *(abs(a[n] - s["action"][n]) for n in ("angular", "linear", "arm_yaw")),
                          *(abs(x - y) for x, y in zip(a["rho_theta"], s["action"]["rho_theta"])))
            check(a["stop"] == s["action"]["stop"], "the resumed run stopped elsewhere")
        bit_equal_maps, map_err = tree_diff(resumed.state, steps[-1]["after"])
        log(f"[reality] checkpoint after step {REALITY_CKPT_AFTER} (save_pytree/restore_pytree) resumed in a fresh "
            f"policy on the recorded hook outputs for steps {REALITY_CKPT_AFTER + 1}-{REALITY_ACTIONS}: actions "
            f"bit-equal {bit_equal_actions} (max diff {act_err:.3e}), final state bit-equal {bit_equal_maps} (max "
            f"diff {map_err:.3e}; tol {REALITY_CKPT_ATOL})")
        check(act_err <= REALITY_CKPT_ATOL and map_err <= REALITY_CKPT_ATOL, "the resumed run differs from the live one")

        # The recorded value-map updates, replayed on the CPU, against the
        # same updates on the card (without the explored mask, which a
        # recording does not carry).
        ref = VM.create(spec, cfg.value_channels, device=DEV)
        for s in steps:
            _, hand, cos, value_depth = s["inputs"][:4]
            VM.update(ref, spec, cos, value_depth, hand.tf, 0.0, hand.max_depth, hand.fov)
        rep = VIO.replay(rec_dir, spec, cfg.value_channels, device="cpu")
        far = {n: int(((getattr(rep, n) - getattr(ref, n).cpu()).abs() > REALITY_VALUE_ATOL)
                      .reshape(*rep.conf.shape, -1).any(-1).sum()) for n in ("conf", "values")}
        err = max(float((getattr(rep, n) - getattr(ref, n).cpu()).abs().max()) for n in ("conf", "values"))
        n_rec = len(os.listdir(rec_dir)) - 2
        log(f"[reality] ValueMapRecorder: {n_rec} updates recorded; replay on the CPU against the card's map of the "
            f"same updates: cells beyond {REALITY_VALUE_ATOL} {far} (tol {MAP_FLIPS} of {REALITY_ACTIONS} x 256x256), "
            f"max err {err:.3e}; confidence mass {float(rep.conf.sum()):.1f}")
        check(n_rec == REALITY_ACTIONS and float(rep.conf.sum()) > 0, "the recording is missing updates")
        check(all(f <= MAP_FLIPS * REALITY_ACTIONS * 256 * 256 for f in far.values()),
              "the replayed value map differs from the card's")

    # One get_action at B=1, with and without a detection, each on a new
    # episode's first steps (all five body cameras).
    for label, blind in (("get_action with a detection (ZoeD_NK runs)", False),
                         ("get_action without a detection", True)):
        hooks.blind, ep = blind, {"obs": env.reset(REALITY_TARGET)}
        policy.reset()

        def act():
            ep["action"] = policy.get_action(ep["obs"])  # ends in the action's read back

        def step_env():  # each act's detection flag and body cameras
            seen.append((bool(policy.last_inputs[6].any()), sum(policy.last_inputs[0].valid)))
            ep["obs"] = env.step(ep["action"])

        seen, timed = [], StepTimer()
        before = (counted("K1.launches"), counted("K2.launches"), counted("K3.launches"))
        act()  # a warm-up, and one act's launches
        per_act = [a - b for a, b in zip((counted("K1.launches"), counted("K2.launches"), counted("K3.launches")),
                                         before)]
        step_env()
        for _ in range(REALITY_TIMED):
            with timed.section(label):
                act()
            step_env()
        kernels, copies, busy, pwall = launch_profile(act)
        step_env()
        syncs = host_syncs(act)
        step_env()
        check(seen == [(not blind, REAL.MAX_BODY_CAMS)] * len(seen), f"{label}: (detection, body cameras) {seen}")
        ms = timed.summary()[label]["p50_ms"]
        log(f"[reality-time] B=1 {label}: {ms:.2f} ms wall (median of {REALITY_TIMED}), {1e3 / ms:.1f} actions/s; "
            f"under the profiler {busy:.2f} ms of device time, idle share {1 - busy / pwall:.3f}; {kernels} kernel "
            f"launches + {copies} copies/sets, {syncs} host syncs; K1 {per_act[0]}, K2 {per_act[1]}, K3 "
            f"{per_act[2]} per act; on {smi}")

    # The last step with a detection's parts: perception, ZoeD_NK, the six
    # obstacle updates and reality_step whole, on a copy of its state.
    hooks.blind = False
    policy.reset()
    ep = {"obs": env.reset(REALITY_TARGET)}
    policy.get_action(ep["obs"])
    rgb, inputs, st = ep["obs"]["rgb"], policy.last_inputs, clone_tree(policy.state)
    body, hand = inputs[:2]
    check(bool(inputs[6].any()) and sum(body.valid) == REAL.MAX_BODY_CAMS, "the timed step needs a detection")
    sync_on = policy.rng
    parts = {
        "perception (ITM cosines; OWL-ViT, COCO route, gated SAM)": lambda: (hooks.score(rgb), hooks.detect(rgb)),
        "ZoeD_NK infer_depth": lambda: hooks.infer_depth(rgb, 0.0, hand.max_depth),
        "the six obstacle updates (fuse_cameras)": lambda: REAL.fuse_cameras(st.obstacle, spec, cfg, body, hand,
                                                                            st.steps),
        "reality_step whole": lambda: REAL.reality_step(st, *inputs, pointnav=pointnav, spec=spec, cfg=cfg),
    }
    split = {name: reality_timing(name, fn, sync_on, smi) for name, fn in parts.items()}
    whole, obst = split["reality_step whole"], split["the six obstacle updates (fuse_cameras)"]
    log(f"[reality-time] B=1 the rest of reality_step (value map, object map, frontier choice, PointNav, mode "
        f"machine): {whole['ms'] - obst['ms']:.2f} ms wall, {whole['device_ms'] - obst['device_ms']:.2f} ms device, "
        f"{whole['kernels'] - obst['kernels']} launches, {whole['syncs'] - obst['syncs']} host syncs; on {smi}")
    return launches


# --- phase 26 ----------------------------------------------------------------
def phase_tiny_vitdet() -> None:
    """(a) The tiny ViT-det SAM (``SamConfig.tiny()`` and ``tiny_sam_config``):
    the same f32 weights on the CPU and on the card give the same
    embeddings, iou and masks, ungated, gated and with multimask output."""
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 255, (5, 64, 64, 3)).astype(np.float32))
    lo = rng.uniform(0.0, 0.5, (5, 2, 2))
    boxes = torch.from_numpy(np.concatenate([lo, np.minimum(lo + rng.uniform(0.1, 0.5, (5, 2, 2)), 1.0)], -1)
                             .astype(np.float32))
    valid = torch.tensor([[1, 0], [0, 0], [1, 1], [0, 1], [1, 0]], dtype=torch.bool)
    for name, scfg in (("SamConfig.tiny()", SamConfig.tiny()), ("tiny_sam_config()", tiny_sam_config())):
        cpu = SAM.init_random(scfg, seed=0, device="cpu")
        gpu = SAM(cpu.cfg, copy.deepcopy(cpu.module).to(DEV))
        k1, k2, k3 = counted("K1.launches"), counted("K2.launches"), counted("K3.launches")
        emb_c, emb_g = cpu.encode(imgs), gpu.encode(imgs.to(DEV)).cpu()
        with torch.no_grad():
            lc, ic = cpu.module.decode_boxes(emb_c, boxes)
            lg, ig = gpu.module.decode_boxes(emb_g.to(DEV), boxes.to(DEV))
        emb_err = float((emb_g - emb_c).abs().max() / emb_c.abs().max())
        logit_err = float((lg.cpu() - lc).abs().max() / lc.abs().max())
        iou_err = float((ig.cpu() - ic).abs().max())
        far = lc.abs() > TINY_VITDET_MARGIN * lc.abs().max()
        flips = []
        for multimask in (False, True):
            mc, _ = cpu.segment_boxes(imgs, boxes, multimask)
            mg, _ = gpu.segment_boxes(imgs.to(DEV), boxes.to(DEV), multimask)
            gated, _ = gpu.segment_boxes_gated(imgs.to(DEV), boxes.to(DEV), valid.to(DEV), 2, multimask)
            has = valid.any(1)
            best = torch.argmax(ic[..., 1:], dim=-1) + 1 if multimask else torch.zeros_like(ic[..., 0], dtype=torch.long)
            sel = torch.take_along_dim(far, best[..., None, None, None], dim=2)[:, :, 0]
            flips.append(float((mg.cpu() != mc)[sel].float().mean()))
            check(torch.equal(gated.cpu()[has], mg.cpu()[has]), f"tiny ViT-det {name}: gated differs from ungated")
        launched = (counted("K1.launches") - k1, counted("K2.launches") - k2, counted("K3.launches") - k3)
        log(f"[tiny-vitdet] {name}: card vs CPU embeddings {emb_err:.2e} of the largest entry, mask logits "
            f"{logit_err:.2e}, iou {iou_err:.2e} (tol {TINY_VITDET_RTOL}); masks away from 0 flip {flips} "
            f"(multimask off, on; tol 0); gated equals ungated on the card; K1, K2, K3 launches {launched}")
        check(max(emb_err, logit_err) <= TINY_VITDET_RTOL and iou_err <= TINY_VITDET_RTOL,
              f"tiny ViT-det {name}: card and CPU differ")
        check(max(flips) == 0.0, f"tiny ViT-det {name}: masks away from 0 differ between card and CPU")
        check(launched == (0, 0, 0), f"tiny ViT-det {name}: the encoder launched a kernel")


def encode_timing(label: str, fn, smi: str, tag: str = "vitdet-time") -> dict:
    """Wall (median of 5), device time and idle share (torch.profiler),
    launches, host syncs and the peak of device memory above what was held
    before, of one call of ``fn``."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    kernels, copies, busy, wall = launch_profile(fn)
    r = dict(ms=wall_ms(fn, reps=5, warmup=1), device_ms=busy, idle=1 - busy / wall, kernels=kernels,
             copies=copies, syncs=host_syncs(fn), peak_gib=peak / 2**30)
    log(f"[{tag}] {label}: {r['ms']:.2f} ms wall (median of 5); under the profiler {busy:.2f} ms of device time, "
        f"idle share {r['idle']:.3f}; {kernels} kernel launches + {copies} copies/sets, {r['syncs']} host syncs; "
        f"peak device memory {r['peak_gib']:.2f} GiB above the {held / 2**30:.2f} GiB held; on {smi}")
    return r


def phase_vitdet(det_cfg, det, rgb, smi: str) -> dict:
    """(b) sam-vit-base at full width: ``SamConfig()`` at 1024 px with random
    weights from seed 0 under ``cast_for_serving``, on phase 11's 8 spin
    frames with phase 11's pipeline around it."""
    sam = SAM.init_random(SamConfig(), seed=0, device=DEV)
    cast_for_serving(sam.module)
    n = sum(p.numel() for p in sam.module.parameters())
    n_enc = sum(p.numel() for p in sam.module.vision.parameters())
    log(f"[vitdet] sam-vit-base (ViT-det, 12 blocks at width 768, global attention at 2, 5, 8, 11, 1024 px): "
        f"{n / 1e6:.2f} M parameters ({n_enc / 1e6:.2f} M in the encoder), bf16 weights, f32 compute")
    check(isinstance(sam.module.vision, SamVisionEncoder) and round(n / 1e6, 1) == 93.7,
          "SamConfig() is not sam-vit-base's ViT-det")
    b, h, w = rgb.shape[:3]
    k, cap = det_cfg.max_detections_per_frame, det_cfg.sam_frame_capacity
    # Phase 11's pipeline with ViT-det in place of MobileSAM: both routes
    # for the COCO target, then the open-vocabulary route at threshold 0
    # (every frame holds a detection), gated at capacity 2.
    reset_counters()
    out_coco = make_pipeline(det, sam, det_cfg, cap)(rgb, COCO_TARGET)
    out_open = make_pipeline(det, sam, det_cfg, cap, non_coco_threshold=0.0)(rgb, OPEN_TARGET)
    torch.cuda.synchronize()
    launches = dict(layer_norm=counted("K1.launches"), mbconv_chain=counted("K2.launches"),
                    attention=counted("K3.launches"))
    frames_coco = check_detections(COCO_TARGET, out_coco, b, h, w, k)
    frames_open = check_detections(OPEN_TARGET, out_open, b, h, w, k)
    log(f"[vitdet] phase 11's pipeline with ViT-det SAM: {COCO_TARGET} {int(out_coco[1].sum())} detections on "
        f"{frames_coco} frames, {OPEN_TARGET} at threshold 0 {int(out_open[1].sum())} on {frames_open}; "
        f"K1 {launches['layer_norm']} (expect {3 * LAUNCHES_DETECT}, OWL-ViT's), K2 {launches['mbconv_chain']} "
        f"(expect 0: no TinyViT), K3 {launches['attention']}")
    check(launches["layer_norm"] == 3 * LAUNCHES_DETECT, "ViT-det pipeline K1 launch count")
    launches = with_fused(launches, "vitdet", 3 * FUSED_DETECT)
    check(launches["mbconv_chain"] == 0, "the ViT-det pipeline launched K2: the encoder was not swapped")
    check(frames_open == b, "threshold 0 must put detections on every frame")
    ungated = make_pipeline(det, sam, det_cfg, None, non_coco_threshold=0.0)(rgb, OPEN_TARGET)
    gm, gv, (xyxy, _, _) = out_open
    um, uv, _ = ungated
    check(torch.equal(gv, uv), "ViT-det gated and ungated validity differ")
    flips = float((gm != um)[gv].float().mean())
    log(f"[vitdet] gated (capacity {cap}) against ungated masks on valid slots at B={b}: {flips:.2e} of pixels "
        f"flip (tol {GATED_MASK_FLIPS})")
    check(flips <= GATED_MASK_FLIPS, "ViT-det gated masks differ from ungated masks")

    # Each lane at B=8 against its own B=1 run: embeddings, iou, masks.
    imgs, boxes = resize_bilinear(rgb.to(torch.float32), 1024, 1024), xyxy
    emb8 = sam.encode(imgs)
    check(emb8.shape == (b, 64, 64, 256) and emb8.dtype == torch.float32 and bool(torch.isfinite(emb8).all()),
          "sam-vit-base embeddings: shape, dtype, finite")
    m8, iou8 = sam.decode(emb8, boxes)
    emb_err = iou_err = lane_flips = 0.0
    for lane in range(b):
        e1 = sam.encode(imgs[lane:lane + 1])
        m1, iou1 = sam.decode(e1, boxes[lane:lane + 1])
        emb_err = max(emb_err, float((e1[0] - emb8[lane]).abs().max() / emb8[lane].abs().max()))
        iou_err = max(iou_err, float((iou1[0] - iou8[lane]).abs().max()))
        lane_flips = max(lane_flips, float((m1[0] != m8[lane]).float().mean()))
    log(f"[vitdet] each lane at B={b} against its B=1 run: embeddings within {emb_err:.2e} of the largest entry, "
        f"iou within {iou_err:.2e} (tol {VITDET_LANE_RTOL}), masks flip {lane_flips:.2e} of pixels "
        f"(tol {GATED_MASK_FLIPS})")
    check(emb_err <= VITDET_LANE_RTOL and iou_err <= VITDET_LANE_RTOL, "ViT-det lanes differ from their B=1 runs")
    check(lane_flips <= GATED_MASK_FLIPS, "ViT-det lane masks differ from their B=1 runs")
    del emb8, m8
    for lanes in (1, b):
        x = imgs[:lanes]
        encode_timing(f"B={lanes} sam-vit-base encode (1024 px, f32 compute)", lambda: sam.encode(x), smi)
    return launches


def phase_stochastic_pointnav(smi: str) -> None:
    """(c) Phase 19's full-width PointNav at B=8 with ``deterministic=False``:
    for 16 keys the card's draws equal the CPU's on the same inputs."""
    b = BATCH_LANES
    rng = np.random.default_rng(0)
    depth = torch.from_numpy(rng.uniform(0, 1, (b, 224, 224)).astype(np.float32))
    goal = torch.from_numpy(np.stack([rng.uniform(0.2, 5, b), rng.uniform(-np.pi, np.pi, b)], 1).astype(np.float32))
    for discrete in (True, False):
        gpu = PointNavPolicy.init_random(seed=0, depth_shape=(224, 224), discrete=discrete, device=DEV)
        cpu = PointNavPolicy(copy.deepcopy(gpu.module).cpu())
        state = PointNavState(h=torch.from_numpy(rng.normal(size=(2, b, 512)).astype(np.float32)),
                              c=torch.from_numpy(rng.normal(size=(2, b, 512)).astype(np.float32)),
                              prev_action=torch.zeros(b, 1 if discrete else 2),
                              not_done=torch.ones(b, 1, dtype=torch.bool))
        gstate = PointNavState(*(t.to(DEV) for t in state))
        equal = near = 0
        err = 0.0
        for key in range(STOCHASTIC_KEYS):
            ga, gs = gpu.act(depth.to(DEV), goal.to(DEV), gstate, deterministic=False,
                             rng=threefry.PRNGKey(key, device=DEV))
            ca, cs = cpu.act(depth, goal, state, deterministic=False, rng=threefry.PRNGKey(key, device="cpu"))
            shape = (b, 4) if discrete else (b, 2)
            draw = threefry.gumbel if discrete else threefry.normal
            gd, cd = draw(threefry.PRNGKey(key, device=DEV), shape).cpu(), draw(threefry.PRNGKey(key, device="cpu"),
                                                                                 shape)
            check(torch.equal(gd.view(torch.int32), cd.view(torch.int32)), f"key {key}: the draws differ in bits")
            if discrete:
                scores = cd + cpu.logits(cs)  # the CPU's gumbel-max scores
                top = torch.topk(scores, 2, dim=-1).values
                tie = (top[:, 0] - top[:, 1]) <= 2 * PN_ATOL
                near += int(tie.sum())
                same = ga.cpu()[:, 0] == ca[:, 0]
                check(bool(same[~tie].all()), f"key {key}: the card's categorical draws differ off near ties")
                equal += int(same.sum())
            else:
                with torch.no_grad():
                    _, std = cpu.module.action_distribution(cs.h[-1])
                # mu and std hold to PN_ATOL as phase 19's heads do; the draw scales std's share
                tol = PN_ATOL * (1.0 + std * cd.abs())
                err = max(err, float(((ga.cpu() - ca).abs() / tol).max()))
        if discrete:
            log(f"[pointnav-draw] discrete head, B={b} at 224x224, {STOCHASTIC_KEYS} keys: the gumbel draws are "
                f"bit-equal on the card and the CPU (0 ulps); {equal} of {b * STOCHASTIC_KEYS} sampled actions "
                f"equal, {near} near ties (top two within {2 * PN_ATOL}) exempt; on {smi}")
        else:
            log(f"[pointnav-draw] continuous head, B={b}, {STOCHASTIC_KEYS} keys: the normal draws are bit-equal "
                f"(0 ulps); mu + std * draw within {err:.3f} of its tolerance PN_ATOL * (1 + std * |draw|) of the "
                f"CPU's; on {smi}")
            check(err <= 1.0, "the card's continuous draws differ from the CPU's")


def phase_semexp(engine: PerceptionEngine, det, sam, pointnav, smi: str) -> dict:
    """(d) ``evaluate_semexp`` over ``FakeSemExpVecEnv``: one short episode
    with phase 24's agent (the full stack at full width, B=1)."""
    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=SAM_CAPACITY)
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    perception = FullStackPerception(cfg, itm=engine.itm, detector=det, sam=sam,
                                     det_threshold=cfg.non_coco_threshold, device=DEV)
    agent = SemExpVLFMAgent(cfg, spec, pointnav, perception, device=DEV)
    envs = FakeSemExpVecEnv(lambda i: FakeObjectNavEnv(two_room_plan(seed=i), EnvConfig(max_steps=SEMEXP_STEPS)), 1,
                            goal_name=HABITAT_TARGET)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        t0 = time.perf_counter()
        results = evaluate_semexp(envs, agent, 1, max_episode_length=SEMEXP_STEPS + 1, log_dir=tmp, print_fn=log)
        wall = time.perf_counter() - t0
        logged = sorted(os.listdir(tmp))
    launches = with_fused(dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"),
                               mbconv_chain=counted("K2.launches")), "semexp")
    check(len(results) == 1 and len(logged) == 1, "evaluate_semexp lost its episode or its log")
    r = results[0]
    check(all(math.isfinite(r[key]) for key in ("success", "spl", "distance_to_goal")), "SemExp metrics finite")
    log(f"[semexp] evaluate_semexp over FakeSemExpVecEnv (two_room_plan, at most {SEMEXP_STEPS} steps, v2, "
        f"phase 24's agent): {r}; {wall:.2f} s; K1 {launches['layer_norm']}, K2 {launches['mbconv_chain']}, "
        f"K3 {launches['attention']} launches; on {smi}")
    return launches


def phase_sharded_farm(spec, oracle: dict, smi: str, mesh=None, label: str = "make_mesh(1)",
                       episodes: int = FARM_EPISODES) -> None:
    """(e) Phase 20's oracle-fed farm with ``sharding=`` over a one-device
    mesh (``mesh`` None; phase 28 passes its (2, 2) mesh and fewer
    episodes) equals the unsharded farm field for field on its first
    ``episodes`` seeds."""
    cfg = VLFMConfig()
    if mesh is None:
        mesh = make_mesh(1)
        check(mesh.shape == {"data": 1, "model": 1} and mesh.data_devices() == [DEV], "the one-card mesh")
    seeds = list(range(episodes))
    res, stats = run_episodes_farm(seeds, lanes=BATCH_LANES, pointnav="greedy", spec=spec, cfg=cfg,
                                   plan_name="open_room_plan", env_cfg=EnvConfig(), workers=FARM_WORKERS,
                                   max_steps=EPISODE_STEPS, sharding=episode_sharding(mesh))
    check(set(res) == set(seeds), "the sharded farm lost an episode")
    for seed in seeds:
        check(dataclasses.asdict(res[seed]) == dataclasses.asdict(oracle[seed]),
              f"sharded farm seed {seed}: {res[seed]} against the unsharded farm's {oracle[seed]}")
    log(f"[mesh] the oracle farm with sharding=episode_sharding({label}) (unpacked transport, one dispatch "
        f"per data row) equals phase 20's unsharded farm field for field over {episodes} episodes; "
        f"{farm_summary(stats)}; on {smi}")


# --- phase 27 ----------------------------------------------------------------
def state_dicts_equal(got: torch.nn.Module, want: torch.nn.Module) -> bool:
    a, b = got.state_dict(), want.state_dict()
    return list(a) == list(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in b)


def seeded_checkpoint(shapes: dict, seed: int) -> dict:
    """A state dict of seeded f32 tensors for a key -> shape table, the
    BatchNorms' running variances positive."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        v = rng.normal(0, 0.05, shape).astype(np.float32)
        sd[k] = torch.from_numpy(np.abs(v) + 0.5 if k.endswith("running_var") else v)
    return sd


def phase_bundle(engine: PerceptionEngine, det, sam, spec, record: list, rgb: torch.Tensor, smi: str) -> dict:
    """(a) save phase 20's models as a bundle and load it onto the card;
    (b) convert a full-width MobileSAM checkpoint with the CLI and segment
    with it; (c) serve the full stack from the bundle, held bit for bit to
    the in-memory stack on phase 20's inputs; (d) run.py --weights-dir."""
    from vlfm_tpu_torch.models.sam import convert_mobile_sam, expected_mobile_sam_checkpoint_keys
    from vlfm_tpu_torch.runner.weights import full_stack_from_bundle, load_bundle, save_bundle

    b = BATCH_LANES
    cfg = dataclasses.replace(VLFMConfig(), sam_frame_capacity=SAM_CAPACITY)
    with tempfile.TemporaryDirectory(prefix="vlfm-bundle-") as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        with open(vocab, "w", encoding="utf-8") as f:
            f.write("\n".join(toy_vocab()) + "\n")
        t0 = time.perf_counter()
        path = save_bundle(os.path.join(tmp, "bundle"), itm=engine.itm, detector=det, sam=sam, vocab_file=vocab)
        save_s = time.perf_counter() - t0
        loaded = load_bundle(path, device=DEV)
        sizes = {n: os.path.getsize(os.path.join(path, f"{n}.pt")) / 2**30 for n in ("itm", "detector", "sam")}
        for name, want in (("itm", engine.itm), ("detector", det), ("sam", sam)):
            got = getattr(loaded, name)
            check(got.cfg == want.cfg and state_dicts_equal(got.module, want.module),
                  f"bundle: {name} loads other weights or another config than were saved")
        log(f"[bundle] save_bundle of phase 20's BLIP2-ITM, OWL-ViT and MobileSAM (bf16 under cast_for_serving) "
            f"and the toy vocab: {save_s:.2f} s; load_bundle onto the card, per entry: "
            + ", ".join(f"{n} {sizes[n]:.3f} GiB in {loaded.seconds[n]:.2f} s "
                        f"({sizes[n] / max(loaded.seconds[n], 1e-9):.2f} GiB/s)" for n in sizes)
            + f"; every state dict bit-equal to the in-memory model's, configs equal; on {smi}")
        del loaded

        # (b) a full-width mobile_sam.pt through the converter CLI
        scfg = SamConfig.mobile_sam()
        ckpt = seeded_checkpoint(expected_mobile_sam_checkpoint_keys(scfg), seed=0)
        pt = os.path.join(tmp, "mobile_sam.pt")
        torch.save(ckpt, pt)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "vlfm_tpu_torch.convert_checkpoints", "--out",
                              os.path.join(tmp, "converted"), "--mobile-sam", pt, "--vocab", vocab],
                             capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        convert_s = time.perf_counter() - t0
        check(out.returncode == 0, f"convert_checkpoints exited {out.returncode}: {out.stderr[-2000:]}")
        converted = load_bundle(os.path.join(tmp, "converted"), device=DEV)
        want = SAM.from_jax_params(scfg, convert_mobile_sam({k: v.numpy() for k, v in ckpt.items()}, scfg),
                                   device=DEV)
        cast_for_serving(want.module)
        check(converted.sam.cfg == scfg and state_dicts_equal(converted.sam.module, want.module),
              "the converted MobileSAM differs from the converter's tree loaded and cast on the card")
        pipe = make_pipeline(det, converted.sam, cfg, SAM_CAPACITY)
        reset_counters()
        masks, valid, _ = pipe(rgb, COCO_TARGET)
        torch.cuda.synchronize()
        k2 = counted("K2.launches")
        check(k2 > 0 and masks.shape[:2] == valid.shape and bool(valid.any()),
              "the converted MobileSAM segmented nothing or launched no K2")
        log(f"[bundle] a full-width mobile_sam.pt ({len(ckpt)} tensors, "
            f"{sum(v.numel() for v in ckpt.values()) / 1e6:.2f} M values, seeded) through python -m "
            f"vlfm_tpu_torch.convert_checkpoints: exit 0 in {convert_s:.2f} s; on the card its state dict equals "
            f"the converter's tree loaded and cast; phase 11's pipeline with it on the 8 spin frames: "
            f"{int(valid.sum())} valid detections, K2 {k2}; on {smi}")
        del converted, want, pipe

        # (c) the full stack served from the bundle against the in-memory stack, on phase 20's inputs
        served = full_stack_from_bundle(cfg, path, device=DEV)
        direct = FullStackPerception(cfg, itm=engine.itm, detector=det, sam=sam, device=DEV)
        direct.tokenizer = direct.engine.tokenizer = served.tokenizer  # the bundle's vocabulary
        pointnav = PointNavPolicy.init_random(seed=0, depth_shape=tuple(cfg.depth_image_shape), device=DEV)
        layout = full_stack_layout(b, *record[0]["inputs"]["depth"].shape[1:])
        counter = served.pipeline = CountingPipeline(served.pipeline)
        stacks = [(p, p.make_fused_step(pointnav, spec, cfg, COCO_TARGET, layout=layout)) for p in (served, direct)]
        buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=True)
        views = packing.pack_views(buf.numpy(), layout)
        states = [ITM.create_state(spec, cfg, batch=b, device=DEV) for _ in stacks]
        for p, _ in stacks:  # text features and queries cached before the counts
            p.engine.text_features(COCO_TARGET)
            p.pipeline._queries(COCO_TARGET)
            p.pipeline.coco_detector._coco_queries()
        counts, k1_fused = [], []
        for k, r in enumerate(record[:BUNDLE_STEPS]):
            for name, v in views.items():
                v[...] = r["inputs"][name]
            outs = []
            for i, (_, fused) in enumerate(stacks):
                reset_counters()
                out, states[i] = fused(states[i], None, buf)
                outs.append(out.cpu())
                if i == 0:
                    counts.append((counted("K1.launches"), counted("K2.launches"), counted("K3.launches")))
                    k1_fused.append(counted("K1.fused_launches"))
            check(torch.equal(outs[0], outs[1]), f"bundle-served dispatch {k}: outputs differ from the in-memory "
                  f"stack's ({(outs[0] != outs[1]).sum().item()} values)")
        flat = [[t for f in s_ for t in (f if isinstance(f, tuple) else (f,))] for s_ in states]
        check(all(torch.equal(x, y) for x, y in zip(*flat)), "bundle-served state differs from the in-memory one")
        frames = [int(f) for f in counter.frames]
        want_counts = [(LAUNCHES_IMAGE + 2 * LAUNCHES_DETECT, chain_launches(sam.cfg.tinyvit) * -(-f // SAM_CAPACITY),
                        ATTN_LAUNCHES_IMAGE) for f in frames]
        check(counts == want_counts, f"bundle-served dispatches: K1, K2, K3 launches {counts}, expected {want_counts}")
        launches = dict(layer_norm=sum(c[0] for c in counts), mbconv_chain=sum(c[1] for c in counts),
                        attention=sum(c[2] for c in counts), layer_norm_fused=sum(k1_fused))
        check(k1_fused == [FUSED_STEP] * len(counts), f"bundle-served dispatches: fused K1 launches {k1_fused}, "
              f"expected {FUSED_STEP} each")
        st = states[0]._replace(steps=states[0].steps + 1)
        timing = step_timings("bundle-served fused dispatch", b, lambda: stacks[0][1](st, None, buf)[0].cpu(), smi)
        log(f"[bundle] full_stack_from_bundle (the bundle's vocab, max_len {served.tokenizer.max_len}) against "
            f"FullStackPerception over the in-memory models with that vocab: {BUNDLE_STEPS} of phase 20's B={b} "
            f"packed dispatches bit for bit (outputs and state); per dispatch K1, K2, K3 {counts}; one dispatch "
            f"{timing['ms']:.2f} ms wall, {timing['device_ms']:.2f} ms device, idle {timing['idle']:.3f}; on {smi}")
        del served, direct, stacks, states, st

        # (d) run.py serving the bundle over the sim farm
        run_out = cli_json(["vlfm_tpu_torch.run", "--backend", "synthetic", "--farm", str(BUNDLE_FARM["lanes"]),
                            "--episodes", str(BUNDLE_FARM["episodes"]), "--max-steps", str(BUNDLE_FARM["steps"]),
                            "--weights-dir", path])
        check(run_out["episodes"] == BUNDLE_FARM["episodes"] and run_out["avg_steps"] > 0,
              f"run.py --weights-dir's aggregate {run_out}")
        log(f"[bundle] run.py --farm {BUNDLE_FARM['lanes']} --weights-dir: {json.dumps(run_out)}; on {smi}")
    return launches


# --- phase 28 ----------------------------------------------------------------
def split_calls(rows) -> tuple[list, list]:
    """Forward hooks on every ``SplitDense`` and every whole ``Dense`` of
    each row: per row, a count of split calls, of split calls over other
    than TP_MESH's model columns, and of whole calls."""
    counts, handles = [], []
    for row in rows:
        c = {"split": 0, "other_shards": 0, "whole": 0}

        def hook(mod, args, out, c=c):
            if isinstance(mod, SplitDense):
                c["split"] += 1
                c["other_shards"] += len(mod.weights) != TP_MESH["model_parallel"]
            else:
                c["whole"] += 1

        handles += [m.register_forward_hook(hook) for m in row.modules()
                    if isinstance(m, (SplitDense, torch.nn.Linear))]
        counts.append(c)
    return counts, handles


def max_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))


@contextlib.contextmanager
def outputs_of(modules):
    """The outputs of ``modules``' calls inside the block, in call order."""
    outs = []
    handles = [m.register_forward_hook(lambda mod, args, out: outs.append(out)) for m in modules]
    try:
        yield outs
    finally:
        for h in handles:
            h.remove()


def swap_shards(split: SplitDense) -> None:
    """Swap a two-column ``SplitDense``'s weight and bias blocks in place."""
    with torch.no_grad():
        for blocks in (split.weights, split.biases):
            if blocks is not None:
                first = blocks[0].clone()
                blocks[0].copy_(blocks[1])
                blocks[1].copy_(first)


def phase_tensor_parallel(engine: PerceptionEngine, det, spec, oracle: dict, rgb: torch.Tensor, smi: str) -> dict:
    """(a) Phase 6's BLIP2-ITM split over a (2, 2) mesh on the card: the 8
    frames 4 + 4 over the data rows, every Dense of the image call split
    over the row's 2 model columns, held to the unsplit B=8 call, K1 and K3
    counted, both timed; (b) phase 11's OWL-ViT split the same way, held to
    the unsplit detect; (c) phase 20's oracle farm over the mesh."""
    mesh = make_mesh(devices=[DEV] * TP_MESH["devices"], model_parallel=TP_MESH["model_parallel"])
    check(mesh.shape == {"data": 2, "model": 2} and mesh.data_devices() == [DEV, DEV]
          and mesh.model_devices(1) == [DEV, DEV], "the (2, 2) mesh")
    log(f"[tp] mesh {mesh.shape}: data rows' lead devices {[str(d) for d in mesh.data_devices()]}, model columns "
        f"{[[str(d) for d in mesh.model_devices(r)] for r in range(2)]}")
    # (a) BLIP2-ITM, tp x dp.
    t0 = time.perf_counter()
    b = rgb.shape[0]
    with outputs_of([engine.itm.module.vision_proj]) as outs:
        want = engine.score(rgb, TARGET)
    want_feats = outs[0]
    held = torch.cuda.memory_allocated()
    t_split = time.perf_counter()
    rows = shard_params_tp(engine.itm.module, mesh)
    torch.cuda.synchronize()
    log(f"[tp] shard_params_tp of BLIP2-ITM over the mesh: {time.perf_counter() - t_split:.2f} s, "
        f"{(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB for the two rows' copies")
    engines = [PerceptionEngine(BLIP2ITM(engine.itm.cfg, row), engine.tokenizer, engine.text_prompt) for row in rows]
    check([e.itm.device for e in engines] == mesh.data_devices(), "a split ITM is not on its row's lead device")
    for e in engines:
        e.text_features(TARGET)
    blocks = shard_episode_batch(rgb, mesh)
    check([tuple(blk.shape) for blk in blocks] == [(b // 2, *rgb.shape[1:])] * 2, "the frames split 4 + 4")

    def split_score():
        return torch.cat([e.score(blk, TARGET) for e, blk in zip(engines, blocks)])

    def agreement(label: str) -> bool:
        """Score through the rows; log the cosines' largest difference from
        the unsplit call's and the image embeddings' relative one, and
        return whether both are within their limits."""
        with outputs_of([row.vision_proj for row in rows]) as outs:
            got = split_score()
        feats = torch.cat(outs)
        check(got.shape == want.shape and feats.shape == want_feats.shape and bool(torch.isfinite(got).all()),
              f"{label}: cosines or embeddings of the wrong shape, or not finite")
        cos_diff, feat_diff = max_diff(got, want), rel_l2(feats, want_feats)
        log(f"[tp] {label}, B={b} as 4 + 4: cosines {tuple(got.shape)} {got.dtype} (largest |cosine| "
            f"{float(want.abs().max()):.3e}), largest difference from the unsplit B={b} call {cos_diff:.3e} "
            f"(limit {TP_COS_ATOL}); vision_proj's output {tuple(feats.shape)}, L2 difference relative to the "
            f"unsplit one's {feat_diff:.3e} (limit {TP_FEAT_RTOL}); bit-equal "
            f"{bool(torch.equal(got, want) and torch.equal(feats, want_feats))}; on {smi}")
        return cos_diff <= TP_COS_ATOL and feat_diff <= TP_FEAT_RTOL

    counts, handles = split_calls(rows)
    torch.cuda.synchronize()
    reset_counters()
    split_score()
    torch.cuda.synchronize()
    launches = dict(layer_norm=counted("K1.launches"), attention=counted("K3.launches"))
    for h in handles:
        h.remove()
    log(f"[tp] Dense calls per row in the split image call: {counts} (expect {TP_DENSE_IMAGE} split, all with "
        f"{TP_MESH['model_parallel']} shards, 0 whole)")
    check(all(c == {"split": TP_DENSE_IMAGE, "other_shards": 0, "whole": 0} for c in counts),
          "a row's image call ran a Dense that is not split over its 2 model columns")
    log(f"[tp] K1 {launches['layer_norm']} launches (expect {2 * LAUNCHES_IMAGE}), K3 {launches['attention']} "
        f"(expect {2 * ATTN_LAUNCHES_IMAGE}): one unsplit image call's per data row")
    check(launches == dict(layer_norm=2 * LAUNCHES_IMAGE, attention=2 * ATTN_LAUNCHES_IMAGE),
          "the split ITM call's K1 or K3 launch count")
    launches = with_fused(launches, "tp", 2 * FUSED_IMAGE)
    check(agreement("BLIP2-ITM split over the (2, 2) mesh"), "the split ITM differs from the unsplit call")
    whole = encode_timing(f"BLIP2-ITM unsplit, B={b} in one call", lambda: engine.score(rgb, TARGET), smi, "tp-time")
    split = encode_timing(f"BLIP2-ITM split over the (2, 2) mesh, B={b} as 4 + 4", split_score, smi, "tp-time")
    log(f"[tp] split against unsplit: device ms x{split['device_ms'] / whole['device_ms']:.2f}, launches "
        f"x{split['kernels'] / whole['kernels']:.2f}, wall x{split['ms'] / whole['ms']:.2f}; on {smi}")
    # The planted fault: row 0's middle ViT-g SplitDense with its shards swapped.
    vit_splits = [(name, m) for name, m in rows[0].vision.named_modules() if isinstance(m, SplitDense)]
    name, fault = vit_splits[len(vit_splits) // 2]
    swap_shards(fault)
    check(not agreement(f"planted fault: row 0's vision.{name} with its 2 shards swapped"),
          "the check passed a split ITM with one SplitDense's shards swapped")
    del rows, engines, split_score, agreement
    torch.cuda.empty_cache()
    # (b) OWL-ViT, the same split.
    t1 = time.perf_counter()
    images = det.preprocess(rgb)
    ids, mask = (torch.as_tensor(a, device=DEV) for a in encode_queries(COCO_CLASSES))
    want_boxes, want_logits = det.detect(images, ids, mask)
    rows = shard_params_tp(det.module, mesh)
    n_split = [sum(isinstance(m, SplitDense) for m in row.modules()) for row in rows]
    outs = [OwlViTDetector(det.cfg, row).detect(blk, ids, mask)
            for row, blk in zip(rows, shard_episode_batch(images, mesh))]
    boxes, logits = (torch.cat(t) for t in zip(*outs))
    box_diff, logit_diff = max_diff(boxes, want_boxes), max_diff(logits, want_logits)
    log(f"[tp] OWL-ViT base-32 split over the (2, 2) mesh ({n_split} SplitDense per row), B={b} as 4 + 4 over the "
        f"{len(COCO_CLASSES)} COCO prompts: largest difference from the unsplit detect: boxes {box_diff:.3e}, "
        f"logits {logit_diff:.3e} (largest |logit| {float(want_logits.float().abs().max()):.2f}; tolerance "
        f"{TP_OWL_ATOL}), bit-equal {bool(torch.equal(boxes, want_boxes) and torch.equal(logits, want_logits))}; on {smi}")
    check(boxes.shape == want_boxes.shape and logits.shape == want_logits.shape, "split OWL-ViT shapes")
    check(box_diff <= TP_OWL_ATOL and logit_diff <= TP_OWL_ATOL, "split OWL-ViT differs from the unsplit detect")
    del rows, outs
    torch.cuda.empty_cache()
    # (c) The farm over the mesh.
    t2 = time.perf_counter()
    phase_sharded_farm(spec, oracle, smi, mesh, "make_mesh(devices=[cuda:0] * 4, model_parallel=2)", TP_FARM_EPISODES)
    log(f"[tp] phase 28 by part: (a) ITM {t1 - t0:.1f} s, (b) OWL-ViT {t2 - t1:.1f} s, (c) the farm "
        f"{time.perf_counter() - t2:.1f} s")
    return launches


def farm_summary(stats) -> str:
    return (f"{stats.env_steps} env steps in {stats.wall_time:.2f} s ({stats.steps_per_sec:.1f} env-steps/s), "
            f"{stats.dispatches} dispatches, "
            f"{stats.bytes_put} bytes put in {stats.t_put * 1e3:.1f} ms; driver time: drain {stats.t_drain:.2f} s, "
            f"dispatch {stats.t_dispatch:.2f} s, sync {stats.t_sync:.2f} s, idle {stats.t_idle:.2f} s")


def build_main_path():
    """The full-width configuration of phase 6: policy config, map grid,
    the perception engine with random bf16 weights, and the spin's views."""
    cfg = VLFMConfig()
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    itm = BLIP2ITM.init_random(BLIP2ITMConfig(), seed=0, device=DEV)
    cast_for_serving(itm.module)
    engine = PerceptionEngine(itm, WordPieceTokenizer(toy_vocab()), cfg.text_prompt)
    return cfg, spec, engine, spin_views(SPIN_VIEWS)


def kernel_record(name: str, replaces: str, launches_by_path: dict, timed: dict) -> dict:
    """One kernel's entry of the JSON line: its launches on each path's run
    (counts set to 0 just before the run), and the numbers of its timed case."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"vlfm_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        **{k: timed[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{k: timed[k] for k in ("launch_floor_ms", "host_us") if k in timed},
    }


def main() -> None:
    marks = [("start", time.perf_counter())]

    def lap(name: str) -> None:
        marks.append((name, time.perf_counter()))

    smi = phase_device()
    phase_build()
    lap("0-1 device, build")
    ln, ln_add = phase_layer_norm()
    k3 = phase_attention()
    lap("2-3 K1, K3")
    phase_tiny_model()
    phase_tiny_obstacle_map()
    flood, label = phase_sweeps()
    lap("4-5 tiny ITM, tiny map, sweep kernels")

    cfg, spec, engine, views = build_main_path()
    n_params = sum(p.numel() for p in engine.itm.module.parameters())
    log(f"[main] BLIP2-ITM ViT-g/14 + Q-Former: {n_params / 1e9:.3f} B parameters, bf16 serving")

    main_run = phase_main_path(views, engine, spec, cfg)
    phase_value_map_check(views, spec, cfg)
    phase_timing(views, engine, spec, cfg, smi)
    lap("6-8 ITM spin")

    k2 = phase_mbconv_chain()
    phase_tiny_pipeline()
    det_cfg, det, sam, rgb = build_detection_path()
    n_det = sum(p.numel() for p in det.module.parameters())
    n_sam = sum(p.numel() for p in sam.module.parameters())
    log(f"[detect] OWL-ViT base-32 {n_det / 1e6:.1f} M + MobileSAM {n_sam / 1e6:.2f} M parameters, bf16 serving")
    det_run = phase_detection_path(det_cfg, det, sam, rgb)
    phase_detection_timing(det_cfg, det, sam, rgb, smi)
    phase_fused_route(engine, det, rgb)
    lap("9-12 detection")

    k4 = phase_deform_gather()
    phase_tiny_gdino_pipeline()
    gd, adapter = build_gdino_path()
    n_gd = sum(p.numel() for p in gd.module.parameters())
    log(f"[gdino] GroundingDINO SwinT-OGC (Swin-T 800 px, BERT-base, 900 queries, 256 tokens): "
        f"{n_gd / 1e6:.1f} M parameters, bf16 weights")
    gdino_run = phase_gdino_path(det_cfg, adapter, det, sam, rgb)
    phase_gdino_timing(det_cfg, adapter, sam, rgb, smi)
    del gd, adapter
    lap("13-16 GroundingDINO")

    batched_run = phase_batched_spin(engine, spec, cfg, smi)
    lap("17 batched spin")
    objmap_run = phase_object_map(det_cfg, det, sam, smi)
    lap("18 object map")
    episodes_run, recycled = phase_batched_episodes(engine, spec, cfg, smi)
    lap("19 batched episodes")
    full_stack_run, oracle_farm, full_stack_record = phase_full_stack(engine, det, sam, spec, recycled, smi)
    full_stack_record = full_stack_record[:BUNDLE_STEPS]
    lap("20 full stack, farm")

    phase_tiny_vqa()
    bridge = build_vqa_bridge()
    n_vqa = sum(p.numel() for p in bridge.module.parameters())
    n_t5 = sum(p.numel() for p in bridge.t5.module.parameters())
    log(f"[vqa] BLIP-2 flan-T5-XL: visual prefix (EVA ViT-g, Q-Former, projection) {n_vqa / 1e9:.3f} B + flan-t5-xl "
        f"{n_t5 / 1e9:.3f} B parameters, bf16 weights; device memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB")
    veto_run = phase_vqa_veto(bridge, rgb, smi)
    vqa_stack_run = phase_vqa_full_stack(engine, det, sam, bridge, spec, smi)
    del bridge
    lap("21 VQA veto")
    phase_tiny_zoedepth()
    zoe = phase_zoedepth(engine, det, sam, rgb, smi)
    lap("22 ZoeDepth")
    phase_bc_tiny()
    fitted = phase_bc(spec, smi)
    lap("23 behaviour cloning")
    habitat_run = phase_habitat_eval(engine, det, sam, fitted, smi)
    lap("24 Habitat-protocol loop, CLIs")
    reality_run = phase_reality(engine, det, sam, zoe, smi)
    lap("25 robot path")
    del zoe
    phase_tiny_vitdet()
    vitdet_run = phase_vitdet(det_cfg, det, rgb, smi)
    phase_stochastic_pointnav(smi)
    semexp_run = phase_semexp(engine, det, sam, fitted, smi)
    phase_sharded_farm(spec, oracle_farm, smi)
    lap("26 ViT-det SAM, stochastic PointNav, SemExp, mesh")
    bundle_run = phase_bundle(engine, det, sam, spec, full_stack_record, rgb, smi)
    lap("27 bundle")
    tp_run = phase_tensor_parallel(engine, det, spec, oracle_farm, rgb, smi)
    lap("28 tensor parallelism")
    del engine, det, sam
    log("[phase-time] " + "; ".join(f"{name} {t - t0:.1f} s" for (_, t0), (name, t) in zip(marks, marks[1:]))
        + f"; total {marks[-1][1] - marks[0][1]:.1f} s")

    check(main_run["layer_norm"] > 0, "the ITM path launched no layer_norm kernel")
    check(main_run["attention"] > 0, "the ITM path launched no attention kernel")
    check(det_run["layer_norm"] > 0, "the detection path launched no layer_norm kernel")
    check(det_run["mbconv_chain"] > 0, "the detection path launched no mbconv_chain kernel")
    check(gdino_run["deform_gather"] > 0, "the GroundingDINO path launched no deform_gather kernel")
    check(gdino_run["mbconv_chain"] > 0, "the GroundingDINO path launched no mbconv_chain kernel")
    check(batched_run["layer_norm"] > 0 and batched_run["attention"] > 0, "the batched spin launched no K1 or K3")
    check(objmap_run["layer_norm"] > 0 and objmap_run["mbconv_chain"] > 0, "the object-map path launched no K1 or K2")
    check(episodes_run["layer_norm"] > 0 and episodes_run["attention"] > 0, "the decision step launched no K1 or K3")
    check(all(full_stack_run[k] > 0 for k in ("layer_norm", "attention", "mbconv_chain")),
          "the full-stack step launched no K1, K2 or K3")
    check(all(r[k] > 0 for r in (episodes_run, full_stack_run) for k in ("flood", "label")),
          "the decision step or the full-stack step launched no flood or labelling kernel")
    check(veto_run["layer_norm"] > 0 and veto_run["attention"] > 0, "the veto launched no K1 or K3")
    check(all(vqa_stack_run[k] > 0 for k in ("layer_norm", "attention", "mbconv_chain")),
          "the full stack with the veto launched no K1, K2 or K3")
    check(all(habitat_run[k] > 0 for k in ("layer_norm", "attention", "mbconv_chain")),
          "the Habitat-protocol loop launched no K1, K2 or K3")
    check(all(reality_run[k] > 0 for k in ("layer_norm", "attention", "mbconv_chain")),
          "the robot path launched no K1, K2 or K3")
    check(vitdet_run["layer_norm"] > 0 and vitdet_run["mbconv_chain"] == 0,
          "the ViT-det detection path launched no K1, or launched K2")
    check(all(semexp_run[k] > 0 for k in ("layer_norm", "attention", "mbconv_chain")),
          "the SemExp loop launched no K1, K2 or K3")
    check(all(bundle_run[k] > 0 for k in ("layer_norm", "attention", "mbconv_chain")),
          "the bundle-served full stack launched no K1, K2 or K3")
    check(tp_run["layer_norm"] > 0 and tp_run["attention"] > 0, "the split ITM path launched no K1 or K3")
    k1_runs = {"itm_spin": main_run, "detection": det_run, "gdino_detection": gdino_run,
               "batched_spin": batched_run, "object_map": objmap_run, "decision_step": episodes_run,
               "full_stack_step": full_stack_run, "vqa_veto": veto_run, "vqa_full_stack_step": vqa_stack_run,
               "habitat_eval": habitat_run, "reality": reality_run, "vitdet_detection": vitdet_run,
               "semexp": semexp_run, "bundle_full_stack": bundle_run, "tensor_parallel_itm": tp_run}
    check(all(r["layer_norm_fused"] > 0 for r in k1_runs.values()), "a K1 path launched no fused add_layer_norm")
    record = {
        "kernels": [
            # K1's launches from both entries; "fused" is the share of them
            # that took the add before them, and the fused entry's timed case.
            {**kernel_record("layer_norm", "vlfm_tpu/ops/norms.py:41",
                             {p: r["layer_norm"] for p, r in k1_runs.items()}, ln),
             "fused": {"launches": sum(r["layer_norm_fused"] for r in k1_runs.values()),
                       "launches_by_path": {p: r["layer_norm_fused"] for p, r in k1_runs.items()},
                       **{k: v for k, v in ln_add.items() if k != "library_ms"}}},
            kernel_record("mbconv_chain", "vlfm_tpu/ops/conv_fused.py:136",
                          {"detection": det_run["mbconv_chain"], "gdino_detection": gdino_run["mbconv_chain"],
                           "object_map": objmap_run["mbconv_chain"],
                           "full_stack_step": full_stack_run["mbconv_chain"],
                           "vqa_full_stack_step": vqa_stack_run["mbconv_chain"],
                           "habitat_eval": habitat_run["mbconv_chain"], "reality": reality_run["mbconv_chain"],
                           "vitdet_detection": vitdet_run["mbconv_chain"], "semexp": semexp_run["mbconv_chain"],
                           "bundle_full_stack": bundle_run["mbconv_chain"]}, k2),
            kernel_record("attention", "vlfm_tpu/ops/attention.py:55",
                          {"itm_spin": main_run["attention"], "batched_spin": batched_run["attention"],
                           "decision_step": episodes_run["attention"],
                           "full_stack_step": full_stack_run["attention"], "vqa_veto": veto_run["attention"],
                           "vqa_full_stack_step": vqa_stack_run["attention"],
                           "habitat_eval": habitat_run["attention"], "reality": reality_run["attention"],
                           "vitdet_detection": vitdet_run["attention"], "semexp": semexp_run["attention"],
                           "bundle_full_stack": bundle_run["attention"],
                           "tensor_parallel_itm": tp_run["attention"]}, k3),
            kernel_record("deform_gather", "vlfm_tpu/ops/deform_gather.py:85",
                          {"gdino_detection": gdino_run["deform_gather"]}, k4),
            # replace no TPU kernel: JAX runs both loops as lax.while_loop over jnp
            *({**kernel_record(name, "none", {p: episodes_run[name] if p == "decision_step" else
                                              full_stack_run[name] for p in ("decision_step", "full_stack_step")},
                               timed), "source": "vlfm_tpu_torch/csrc/sweeps.cu",
               **{k: timed[k] for k in ("wall_ms", "sweeps", "plain_sweeps", "sweep_us", "barrier_us",
                                        "corridor_sweep_us")}}
              for name, timed in (("flood", flood), ("label", label))),
        ]
    }
    print(json.dumps(record), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
