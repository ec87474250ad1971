"""Convert the published checkpoints into a serving bundle.

Counterpart of ``scripts/convert_checkpoints.py``. Run it once on a machine
that holds the model files; the output directory is the only serving
artifact (``run.py --weights-dir``):

    python -m vlfm_tpu_torch.convert_checkpoints --out bundle/ \\
        --blip2-itm  blip2-itm-vit-g/pytorch_model.bin \\
        --owl-vit    owlvit-base-patch32/pytorch_model.bin \\
        --mobile-sam mobile_sam.pt \\
        --vocab      bert-base-uncased/vocab.txt \\
        [--f32]      # keep the checkpoints' f32 instead of the bf16 serving cast

Inputs are torch ``.bin``/``.pt``/``.pth`` files or ``.safetensors`` (read
with the ``safetensors`` package). Each checkpoint goes through its model
module's converter (the JAX package's tree, leaf for leaf) into the port's
module on the CPU, then ``cast_for_serving`` to bf16; ZoeDepth stays f32,
as depth regression needs. One checkpoint is read at a time.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> None:
    from vlfm_tpu_torch.models.precision import cast_for_serving
    from vlfm_tpu_torch.runner.weights import load_state_dict_file, save_bundle

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--blip2-itm", help="Salesforce/blip2-itm-vit-g state dict")
    p.add_argument("--owl-vit", help="google/owlvit-base-patch32 state dict")
    p.add_argument("--mobile-sam", help="mobile_sam.pt (TinyViT encoder)")
    p.add_argument("--grounding-dino", help="IDEA grounding-dino-tiny/base state dict")
    p.add_argument("--zoedepth", help="Intel/zoedepth-nyu(-kitti) state dict")
    p.add_argument("--blip2-t5", help="Salesforce/blip2-flan-t5-xl state dict (VQA veto)")
    p.add_argument("--vocab", help="BERT WordPiece vocab.txt")
    p.add_argument("--f32", action="store_true", help="skip the bf16 serving cast (CPU parity work)")
    args = p.parse_args(argv)

    dtype = None if args.f32 else torch.bfloat16
    models = {}

    def convert(key, path, label, build, serve_dtype=dtype):
        """``build(state dict)`` -> a wrapper on the CPU, cast for serving."""
        if not path:
            return
        model = build(load_state_dict_file(path))  # the checkpoint's arrays go when it returns
        for module in (model.module, getattr(getattr(model, "t5", None), "module", None)):
            if module is not None and serve_dtype is not None:
                cast_for_serving(module, serve_dtype)
        models[key] = model
        print(f"converted {label}", flush=True)

    if args.blip2_itm:
        from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig, convert_hf_state_dict

        cfg = BLIP2ITMConfig()
        convert("itm", args.blip2_itm, "BLIP2-ITM",
                lambda sd: BLIP2ITM.from_jax_params(cfg, convert_hf_state_dict(sd, cfg), device="cpu"))
    if args.owl_vit:
        from vlfm_tpu_torch.models.owl_vit import OwlViTDetConfig, OwlViTDetector, convert_hf_owlvit

        cfg = OwlViTDetConfig(compute_dtype=dtype or torch.float32)
        convert("detector", args.owl_vit, "OWL-ViT",
                lambda sd: OwlViTDetector.from_jax_params(cfg, convert_hf_owlvit(sd, cfg), device="cpu"))
    if args.mobile_sam:
        from vlfm_tpu_torch.models.sam import SAM, SamConfig, convert_mobile_sam

        cfg = SamConfig.mobile_sam()
        convert("sam", args.mobile_sam, "MobileSAM",
                lambda sd: SAM.from_jax_params(cfg, convert_mobile_sam(sd, cfg), device="cpu"))
    if args.grounding_dino:
        from vlfm_tpu_torch.models.grounding_dino import (
            GroundingDinoConfig, GroundingDinoDetector, convert_hf_grounding_dino)

        cfg = GroundingDinoConfig()
        convert("gdino", args.grounding_dino, "GroundingDINO",
                lambda sd: GroundingDinoDetector.from_jax_params(cfg, convert_hf_grounding_dino(sd, cfg),
                                                                 device="cpu"))
    if args.zoedepth:
        from vlfm_tpu_torch.models.zoedepth import ZoeDepth, ZoeDepthConfig, convert_hf_zoedepth

        cfg = ZoeDepthConfig()
        convert("zoedepth", args.zoedepth, "ZoeDepth",
                lambda sd: ZoeDepth.from_jax_params(cfg, convert_hf_zoedepth(sd, cfg), device="cpu"),
                serve_dtype=None)  # depth regression is precision-sensitive: the checkpoint's f32
    if args.blip2_t5:
        from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQAConfig, load_blip2_vqa

        cfg = BLIP2VQAConfig.production()  # the flan-t5-xl stack the checkpoint holds
        convert("vqa", args.blip2_t5, "BLIP2-T5 VQA", lambda sd: load_blip2_vqa(sd, cfg, device="cpu"))

    out = save_bundle(args.out, **models, vocab_file=args.vocab)
    print("bundle saved:", out, flush=True)


if __name__ == "__main__":
    main()
